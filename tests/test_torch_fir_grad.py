"""The gradient of the port's FIR 2x downsample, on the CPU.

``downsample_2d_bwd_plain`` (the plain version of the ``fir_up2d`` kernel,
ops/cuda_kernels.py) against ``jax.vjp`` of the JAX package's
``downsample_2d`` (1e-5 abs, the ops bar), against ``torch.autograd`` of
the port's ``downsample_2d_plain``, and through the adjoint identity
<down(x), g> = <x, bwd(g)>, at even, odd and channels_last shapes. Then the
kernel's launch plan (``fir_up2d_plan``), walked block by block with the
kernel's index formulas (csrc/fir_up2d.cu): every output written once, and
each thread's outputs, computed from its own g window by the kernel's
formula, equal to the plain version bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.ops.fir import downsample_2d as jax_downsample_2d
from ditsep_tpu_torch.ops import fir
from ditsep_tpu_torch.ops.cuda_kernels import (
    FIR_MAX_GRID_Y, FIR_THREADS, downsample_2d_bwd_plain, downsample_2d_plain,
    fir_up2d_plan, separable_taps,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CASES = [  # (N, C, H, W), k, gain
    ((2, 3, 16, 24), (1, 3, 3, 1), 1.0),
    ((1, 4, 17, 9), (1, 3, 3, 1), 1.0),     # odd H and W
    ((2, 2, 8, 13), (1, 2, 3, 4), 2.5),     # odd W, asymmetric kernel
    ((1, 6, 2, 2), (1, 3, 3, 1), 1.0),      # the smallest input
]


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,k,gain", CASES)
def test_plain_backward_matches_jax_vjp(shape, k, gain):
    x = _draw(shape, 0)
    n, c, h, w = shape
    g = _draw((n, c, h // 2, w // 2), 1)
    # the JAX op is NHWC
    _, vjp = jax.vjp(lambda a: jax_downsample_2d(a, k, 2, gain),
                     jnp.asarray(x.transpose(0, 2, 3, 1)))
    (want,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    got = downsample_2d_bwd_plain(torch.from_numpy(g), k, (h, w), gain)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,k,gain", CASES)
def test_plain_backward_matches_autograd(shape, k, gain, channels_last):
    x = torch.from_numpy(_draw(shape, 2))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    y = fir.downsample_2d(x, k, 2, gain)  # the CPU path: the plain version
    g = torch.from_numpy(_draw(tuple(y.shape), 3))
    (want,) = torch.autograd.grad(y, x, g)
    got = downsample_2d_bwd_plain(g, k, shape[2:], gain)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,k,gain", CASES)
def test_adjoint_identity(shape, k, gain, dtype):
    """<down(x), g> = <x, bwd(g)>, in float64 sums of the float32 (or
    bf16-rounded) values; the bf16 backward is the f32 one rounded once."""
    x = torch.from_numpy(_draw(shape, 4)).double()
    n, c, h, w = shape
    g = torch.from_numpy(_draw((n, c, h // 2, w // 2), 5))
    lhs = (downsample_2d_plain(x, k, 2, gain) * g.double()).sum()
    dx = downsample_2d_bwd_plain(g, k, (h, w), gain)
    rhs = (x * dx.double()).sum()
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(float(lhs)))
    gb = g.to(DTYPES[dtype])
    dxb = downsample_2d_bwd_plain(gb, k, (h, w), gain)
    assert dxb.dtype == gb.dtype
    assert torch.equal(dxb, downsample_2d_bwd_plain(gb.float(), k, (h, w),
                                                    gain).to(gb.dtype))


def test_plain_backward_rejects_what_it_does_not_take():
    g = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="4-tap"):
        downsample_2d_bwd_plain(g, (1, 2, 1), (8, 8))
    with pytest.raises(ValueError, match="does not fit"):
        downsample_2d_bwd_plain(g, (1, 3, 3, 1), (10, 8))


# ------------------------------------------------------------ launch plan --
def _strides(shape, channels_last):
    n, c, h, w = shape
    return (c * h * w, 1, w * c, c) if channels_last else (c * h * w, h * w,
                                                           w, 1)


def _plan(g_shape, out_hw, dtype, channels_last, misalign=0, **kw):
    return fir_up2d_plan(g_shape, _strides(g_shape, channels_last),
                         DTYPES[dtype], misalign, out_hw, **kw)


def _dot2(a, b, c, d):
    """a*b + c*d in float32, each operation rounded: the kernel's dot2."""
    f = np.float32
    return f(f(f(a) * f(b)) + f(f(c) * f(d)))


def _thread_quad(g2, taps_h, taps_w, r, cols, h, w):
    """The kernel's arithmetic for one thread of one plane: output rows 2r,
    2r+1 at the output columns ``cols``, from its 3-row window of g2."""
    ho, wo = g2.shape

    def gval(row, col):
        return (g2[row, col] if 0 <= row < ho and 0 <= col < wo
                else np.float32(0))

    out = {}
    for col in cols:
        c, odd = divmod(col, 2)
        u = [(_dot2(taps_w[0], gval(r - 1 + k, c + 1), taps_w[2],
                    gval(r - 1 + k, c)) if odd else
              _dot2(taps_w[1], gval(r - 1 + k, c), taps_w[3],
                    gval(r - 1 + k, c - 1))) for k in range(3)]
        for a in range(2):
            if 2 * r + a < h:
                out[2 * r + a, col] = (
                    _dot2(taps_h[1], u[1], taps_h[3], u[0]) if a == 0
                    else _dot2(taps_h[0], u[2], taps_h[2], u[1]))
    return out


def _walk(plan, n_c, h, w):
    """The outputs of every thread of one plane (NCHW) or image
    (channels_last), by the kernel's index formulas: a list of (r, output
    columns, channels) a thread."""
    (bx, by), (gx, _) = plan["block"], plan["grid"]
    v, groups, pairs = plan["v"], plan["groups"], plan["pairs"]
    threads = []
    if plan["layout"] == "nchw":
        row_tiles = -(-pairs // by)
        for bid in range(gx):
            for ty in range(by):
                for tx in range(bx):
                    gi = (bid // row_tiles) * bx + tx
                    r = (bid % row_tiles) * by + ty
                    if gi < groups and r < pairs:
                        cols = [col for col in range(2 * v * gi,
                                                     2 * v * gi + 2 * v)
                                if col < w]
                        threads.append((r, cols, range(n_c)))
    else:
        chan_tiles, col_tiles = -(-groups // bx), -(-(-(-w // 2)) // by)
        for bid in range(gx):
            b = bid // chan_tiles
            for ty in range(by):
                for tx in range(bx):
                    gi = (bid % chan_tiles) * bx + tx
                    j = (b % col_tiles) * by + ty
                    r = b // col_tiles
                    if gi < groups and 2 * j < w:
                        cols = [col for col in (2 * j, 2 * j + 1) if col < w]
                        threads.append((r, cols, range(v * gi, v * gi + v)))
    return threads


@pytest.mark.parametrize("force_path", [None, "scalar"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", [
    (1, 3, 9, 17), (1, 8, 16, 32), (2, 16, 12, 40), (1, 2, 2, 2),
    (1, 1, 5, 1040),  # NCHW scalar: 520 column groups, three column tiles
    (1, 2, 6, 1032),  # NCHW f32 vector: 258 groups, two column tiles
])
def test_plan_writes_every_output_once_with_plain_bits(shape, channels_last,
                                                       dtype, force_path):
    n, c, h, w = shape
    g_shape = (n, c, h // 2, w // 2)
    plan = _plan(g_shape, (h, w), dtype, channels_last,
                 force_path=force_path)
    # one channel or a g of 1 x 1 pixels is dense in both layouts: NCHW
    # is taken first
    cl = plan["layout"] == "channels_last"
    assert cl == (channels_last and c > 1 and g_shape[2:] != (1, 1))
    (bx, by), (gx, gy) = plan["block"], plan["grid"]
    assert 1 <= bx * by <= FIR_THREADS and 1 <= gx < 2 ** 31
    assert gy == min(n if cl else n * c, FIR_MAX_GRID_Y)
    threads = _walk(plan, c, h, w)
    count = np.zeros((c, h, w), np.int64)
    for r, cols, chans in threads:
        for ch in chans:
            for col in cols:
                for a in range(2):
                    if 2 * r + a < h:
                        count[ch, 2 * r + a, col] += 1
    assert count.min() == 1 and count.max() == 1
    # the kernel's arithmetic, thread by thread, for image 0, on the
    # small shapes (the wide ones only walk)
    if w > 64:
        return
    k = (1, 2, 3, 4)
    taps_h, taps_w = separable_taps(np.asarray(k, np.float64), 2.5)
    g = torch.from_numpy(_draw(g_shape, 6)).to(DTYPES[dtype]).float()
    want = downsample_2d_bwd_plain(g, k, (h, w), 2.5)[0].numpy()
    got = np.full((c, h, w), np.nan, np.float32)
    for r, cols, chans in threads:
        for ch in chans:
            for (row, col), val in _thread_quad(g[0, ch].numpy(), taps_h,
                                                taps_w, r, cols, h,
                                                w).items():
                got[ch, row, col] = val
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels_last,g_shape,out_hw,dtype,path", [
    (False, (1, 128, 128, 192), (256, 384), "f32", "vector"),
    (False, (1, 128, 128, 192), (256, 384), "bf16", "vector"),
    (False, (1, 256, 4, 6), (8, 12), "f32", "vector"),  # W 12: 12 % 4
    (False, (1, 256, 4, 6), (8, 12), "bf16", "scalar"),  # 12 % 8
    (False, (1, 8, 8, 4), (17, 9), "f32", "scalar"),  # odd W
    (True, (1, 128, 128, 192), (256, 384), "bf16", "vector"),
    (True, (1, 6, 8, 8), (16, 16), "f32", "scalar"),  # C % 4
])
def test_vector_path_where_it_applies(channels_last, g_shape, out_hw, dtype,
                                      path):
    assert _plan(g_shape, out_hw, dtype, channels_last)["path"] == path
    assert _plan(g_shape, out_hw, dtype, channels_last,
                 misalign=8)["path"] == "scalar"


def test_train_path_shapes_take_the_vector_path():
    """The 12 down-block gradients of the flagship train step, (6, C, 256
    x 384 >> i), i = 0..5: W = 384 >> i is a multiple of 4 (f32) at every
    level and of 8 (bf16) down to i = 4."""
    for i, c in enumerate((128, 128, 256, 256, 256, 256)):
        h, w = 256 >> i, 384 >> i
        for dtype in ("f32", "bf16"):
            plan = _plan((6, c, h // 2, w // 2), (h, w), dtype, False)
            want = "vector" if w % (4 if dtype == "f32" else 8) == 0 \
                else "scalar"
            assert plan["path"] == want


def test_plan_rejects_what_the_kernel_does_not_take():
    g_shape = (1, 4, 4, 4)
    with pytest.raises(ValueError, match="strides"):
        fir_up2d_plan(g_shape, (64, 16, 1, 4), torch.float32, 0, (8, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fir_up2d_plan(g_shape, _strides(g_shape, False), torch.float16, 0,
                      (8, 8))
    with pytest.raises(ValueError, match="does not fit"):
        _plan(g_shape, (10, 8), "f32", False)
    with pytest.raises(ValueError, match="does not fit"):
        _plan((1, 4, 0, 4), (1, 8), "f32", False)
    with pytest.raises(ValueError, match="vector path"):
        _plan(g_shape, (8, 9), "f32", False, force_path="vector")
    with pytest.raises(ValueError, match="force_path"):
        _plan(g_shape, (8, 8), "f32", False, force_path="tiles")
    assert _plan(g_shape, (8, 8), "f32", False,
                 force_path="scalar")["path"] == "scalar"
