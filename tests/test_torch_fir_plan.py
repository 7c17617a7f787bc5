"""The launch plan of the fir_down2d kernel (ops/cuda_kernels.py:
fir_down2d_plan), on the CPU.

The kernel itself needs the card (tests/test_torch_cuda.py); its plan is
Python, so what it decides is tested here: which path each main-path shape
takes, that the grid stays within the card's limits, and, by walking the
plan's blocks and threads with the kernel's own index formulas
(csrc/fir_down2d.cu), that every output element is written exactly once
and that every neighbour column a thread takes by shuffle comes from the
lane that holds it.
"""
import numpy as np
import pytest
import torch

from ditsep_tpu_torch.ops.cuda_kernels import (
    FIR_MAX_GRID_Y, FIR_ROWS, FIR_THREADS, fir_down2d_plan,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the 12 main-path shapes of the flagship at batch 1: (C, H, W)
FLAGSHIP = [(c, 256 >> i, 576 >> i)
            for i, c0 in enumerate((128, 128, 256, 256, 256, 256))
            for c in (c0, 6)]


def _strides(shape, channels_last):
    n, c, h, w = shape
    return (c * h * w, 1, w * c, c) if channels_last else (c * h * w, h * w,
                                                           w, 1)


def _plan(shape, dtype, channels_last, misalign=0, **kw):
    return fir_down2d_plan(shape, _strides(shape, channels_last),
                           DTYPES[dtype], misalign, **kw)


@pytest.mark.parametrize("misalign", [0, 4])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("chw", FLAGSHIP)
def test_vector_path_exactly_where_it_applies(chw, dtype, channels_last,
                                              misalign):
    c, h, w = chw
    v = 4 if dtype == "f32" else 8
    plan = _plan((1, c, h, w), dtype, channels_last, misalign)
    fits = w % (2 * v) == 0 if not channels_last else c % v == 0
    want = "vector" if fits and misalign == 0 else "scalar"
    assert plan["path"] == want
    assert plan["layout"] == ("channels_last" if channels_last else "nchw")
    assert plan["v"] == (v if want == "vector" else 1)


def test_flagship_scalar_shapes():
    """Where the main path (NCHW, aligned) leaves the vector path: W = 36
    and 18 in f32 (not a multiple of 8), W = 72, 36 and 18 in bf16 (not a
    multiple of 16), at both channel counts."""
    scalar = {(dt, w) for (c, h, w) in FLAGSHIP for dt in DTYPES
              if _plan((1, c, h, w), dt, False)["path"] == "scalar"}
    assert scalar == {("f32", 36), ("f32", 18), ("bf16", 72), ("bf16", 36),
                      ("bf16", 18)}


@pytest.mark.parametrize("channels_last,shape", [
    (False, (1, 70000, 8, 8)), (False, (2, 35000, 4, 16)),
    (True, (70000, 2, 8, 8)), (True, (70000, 8, 4, 6)),
    (False, (1, 1, 2, 2 ** 20)), (True, (1, 4096, 2, 6)),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grid_within_limits(channels_last, shape, dtype):
    plan = _plan(shape, dtype, channels_last)
    (bx, by), (gx, gy) = plan["block"], plan["grid"]
    assert 1 <= bx * by <= FIR_THREADS
    assert 1 <= gy <= FIR_MAX_GRID_Y and 1 <= gx < 2 ** 31
    n, c = shape[:2]
    assert gy == min(n * c if not channels_last else n, FIR_MAX_GRID_Y)


def _walk_nchw(plan, shape):
    """Each thread's outputs and the source of its side columns, by the
    index formulas of fir_down2d_nchw for one plane."""
    _, _, h, w = shape
    ho, wo = h // 2, w // 2
    (bx, by), (gx, _) = plan["block"], plan["grid"]
    v, r, groups = plan["v"], plan["rows"], plan["groups"]
    row_tiles = -(-ho // (by * r))
    count = np.zeros((ho, wo), np.int64)
    for bid in range(gx):
        threads = {}
        for ty in range(by):
            for tx in range(bx):
                g = (bid // row_tiles) * bx + tx
                i0 = ((bid % row_tiles) * by + ty) * r
                threads[ty * bx + tx] = (tx, g, i0)
        for tid, (tx, g, i0) in threads.items():
            lane = tid & 31
            active = g < groups and i0 < ho
            left_shfl = lane > 0 and tx > 0
            right_shfl = lane < 31 and tx + 1 < bx and g + 1 < groups
            # a shuffle reads the lane beside in the same warp, which must
            # hold the neighbouring group of the same output rows
            if left_shfl and active:
                _, g2, i2 = threads[tid - 1]
                assert (g2, i2) == (g - 1, i0)
            if right_shfl and active:
                assert tid + 1 in threads and (tid + 1) >> 5 == tid >> 5
                _, g2, i2 = threads[tid + 1]
                assert (g2, i2) == (g + 1, i0)
            if not active:
                continue
            for m in range(r):
                if i0 + m < ho:
                    count[i0 + m, v * g:v * g + v] += 1
    return count


def _walk_nhwc(plan, shape):
    """Each thread's outputs by the index formulas of fir_down2d_nhwc for
    one image, as (ho, wo, C) counts."""
    _, c, h, w = shape
    ho, wo = h // 2, w // 2
    (bx, by), (gx, _) = plan["block"], plan["grid"]
    v, r, groups = plan["v"], plan["rows"], plan["groups"]
    chan_tiles, col_tiles = -(-groups // bx), -(-wo // by)
    count = np.zeros((ho, wo, c), np.int64)
    for bid in range(gx):
        b = bid // chan_tiles
        for ty in range(by):
            for tx in range(bx):
                g = (bid % chan_tiles) * bx + tx
                j = (b % col_tiles) * by + ty
                i0 = (b // col_tiles) * r
                if g >= groups or j >= wo:
                    continue
                for m in range(r):
                    if i0 + m < ho:
                        count[i0 + m, j, v * g:v * g + v] += 1
    return count


@pytest.mark.parametrize("force_path", [None, "scalar"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (2, 3, 17, 9), (1, 16, 9, 40), (3, 2, 2, 2), (1, 8, 33, 160),
    (1, 1, 6, 1030),   # 515 scalar groups: three column tiles
    (1, 2, 5, 2064),   # 258 f32 vector groups: two column tiles
    (1, 16, 8, 18),    # the flagship's deepest plane
    (1, 8, 16, 36),    # the one above it
    (1, 2, 100, 160),  # several row tiles a plane (NCHW f32 and scalar)
])
@pytest.mark.parametrize("channels_last", [False, True])
def test_every_output_written_once(channels_last, shape, dtype, force_path):
    plan = _plan(shape, dtype, channels_last, force_path=force_path)
    assert plan["rows"] == FIR_ROWS[plan["layout"]]
    if plan["layout"] == "channels_last":
        count = _walk_nhwc(plan, shape)
    else:
        count = _walk_nchw(plan, shape)
    assert count.min() == 1 and count.max() == 1


def test_plan_rejects_what_the_kernel_does_not_take():
    shape = (1, 4, 8, 8)
    with pytest.raises(ValueError, match="strides"):
        fir_down2d_plan(shape, (256, 64, 1, 8), torch.float32, 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fir_down2d_plan(shape, _strides(shape, False), torch.float16, 0)
    with pytest.raises(ValueError, match="H, W >= 2"):
        fir_down2d_plan((1, 4, 1, 8), (32, 8, 8, 1), torch.float32, 0)
    with pytest.raises(ValueError, match="vector path"):
        _plan(shape, "f32", False, misalign=8, force_path="vector")
    with pytest.raises(ValueError, match="force_path"):
        _plan(shape, "f32", False, force_path="tiles")
    # forcing the scalar path is always allowed
    assert _plan(shape, "f32", False, force_path="scalar")["path"] == "scalar"


def test_size_one_axes_take_either_layout_as_torch_does():
    """A (N, 1, H, W) tensor is both contiguous and channels_last in
    PyTorch; the plan takes NCHW first, as the wrapper's checks do."""
    x = torch.zeros(2, 1, 6, 8).contiguous(memory_format=torch.channels_last)
    assert x.is_contiguous()
    plan = fir_down2d_plan(tuple(x.shape), x.stride(), x.dtype, 0)
    assert plan["layout"] == "nchw"
