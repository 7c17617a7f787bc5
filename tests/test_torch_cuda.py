"""Tests of the port's CUDA kernels: they need the card and skip without one.

This file imports no JAX, so that it also runs on a machine that has only
PyTorch. There, skip the repository's conftest (it configures JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import math

import numpy as np
import pytest
import torch

from ditsep_tpu_torch.models import NCSNpp
from ditsep_tpu_torch.ops import conv3x3, cuda_kernels, fir, fused_act
from ditsep_tpu_torch.ops.cuda_kernels import bf16_ulp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,k,gain", [
    ((2, 8, 64, 144), (1, 3, 3, 1), 1.0),
    ((1, 6, 17, 9), (1, 2, 3, 4), 2.5),   # odd sizes, asymmetric kernel
    ((3, 5, 2, 2), (1, 3, 3, 1), 1.0),    # the smallest input
    ((2, 16, 8, 18), (1, 3, 3, 1), 1.0),  # the deepest level: W = 18
    ((1, 8, 16, 36), (1, 3, 3, 1), 1.0),  # W = 36: scalar in both dtypes
    ((2, 4, 12, 40), (1, 2, 3, 4), 2.5),  # W % 16 != 0: bf16 scalar
    ((1, 24, 33, 47), (1, 3, 3, 1), 1.0),  # odd H and W, C % 8 == 0
    ((1, 3, 10, 1200), (1, 3, 3, 1), 1.0),  # two column tiles a row
])
def test_fir_down2d_matches_plain(cuda_device, dtype, channels_last, shape,
                                  k, gain):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    before = cuda_kernels.fir_down2d.launches
    y = fir.downsample_2d(x, k, 2, gain)
    torch.cuda.synchronize()
    assert cuda_kernels.fir_down2d.launches == before + 1
    ref = cuda_kernels.downsample_2d_plain(x, k, 2, gain)
    assert y.shape == (shape[0], shape[1], shape[2] // 2, shape[3] // 2)
    assert y.dtype == dtype
    assert y.is_contiguous(memory_format=torch.channels_last
                           if channels_last else torch.contiguous_format)
    peak = ref.float().abs().max().item()
    tol = 1e-6 * peak if dtype == torch.float32 else bf16_ulp(peak)
    assert (y.float() - ref.float()).abs().max().item() <= tol


def _fir_taps():
    return cuda_kernels.separable_taps(np.asarray([1.0, 3.0, 3.0, 1.0]), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last,shape", [
    (False, (2, 8, 64, 144)), (False, (1, 4, 33, 160)),
    (False, (1, 128, 256, 576)),          # level 0 of the flagship
    (True, (2, 32, 20, 36)), (True, (1, 16, 17, 9)),
])
def test_fir_down2d_paths_give_same_bits(cuda_device, dtype, channels_last,
                                         shape):
    """Where the vector path applies, the scalar path gives its bits."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    kern = cuda_kernels.fir_down2d
    assert kern.plan(x)["path"] == "vector"
    before = kern.launches
    vec = kern(x, *_fir_taps(), force_path="vector")
    sca = kern(x, *_fir_taps(), force_path="scalar")
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert torch.equal(vec, sca)
    assert torch.equal(vec, kern(x, *_fir_taps()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_fir_down2d_misaligned_base(cuda_device, dtype, channels_last):
    """A contiguous view at storage offset 1 is not 16-byte aligned: the
    plan takes the scalar path, and forcing the vector one raises."""
    shape = (2, 16, 12, 32)
    n = math.prod(shape)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    buf = torch.randn(n + 1, generator=g, device=cuda_device).to(dtype)
    if channels_last:
        b, c, h, w = shape
        x = buf[1:].view(b, h, w, c).permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
    else:
        x = buf[1:].view(shape)
        assert x.is_contiguous()
    assert x.data_ptr() % 16 != 0
    assert cuda_kernels.fir_down2d.plan(x)["path"] == "scalar"
    with pytest.raises(ValueError, match="vector path"):
        cuda_kernels.fir_down2d(x, *_fir_taps(), force_path="vector")
    y = fir.downsample_2d(x, [1, 3, 3, 1])
    ref = cuda_kernels.downsample_2d_plain(x, [1, 3, 3, 1])
    aligned = fir.downsample_2d(x.clone(memory_format=torch.preserve_format),
                                [1, 3, 3, 1])
    torch.cuda.synchronize()
    assert torch.equal(y, aligned)
    peak = ref.float().abs().max().item()
    tol = 1e-6 * peak if dtype == torch.float32 else bf16_ulp(peak)
    assert (y.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last,shape", [
    (False, (2, 35000, 4, 16)),   # 70,000 planes: gridDim.y loops
    (True, (70000, 8, 4, 6)),     # 70,000 images
])
def test_fir_down2d_many_planes(cuda_device, channels_last, shape):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda_device)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    plan = cuda_kernels.fir_down2d.plan(x)
    assert plan["grid"][1] == 65535 and plan["path"] == "vector"
    y = fir.downsample_2d(x, [1, 3, 3, 1])
    ref = cuda_kernels.downsample_2d_plain(x, [1, 3, 3, 1])
    torch.cuda.synchronize()
    assert (y - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.cuda
def test_cuda_downsample_raises_not_falls_back(cuda_device, monkeypatch):
    x = torch.randn(1, 4, 8, 8, device=cuda_device)
    before = cuda_kernels.fir_down2d.launches
    with pytest.raises(ValueError, match="fir_down2d"):
        fir.downsample_2d(x, [1, 1, 1], factor=3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fir.downsample_2d(x.half(), [1, 3, 3, 1])
    with pytest.raises(ValueError, match="strides"):
        fir.downsample_2d(x.transpose(2, 3), [1, 3, 3, 1])
    with pytest.raises(ValueError, match="H, W >= 2"):
        fir.downsample_2d(x[:, :, :1], [1, 3, 3, 1])
    # the launch plan's own arguments
    with pytest.raises(ValueError, match="force_path"):
        cuda_kernels.fir_down2d(x, *_fir_taps(), force_path="tiles")
    with pytest.raises(ValueError, match="vector path"):  # W = 12: 12 % 8
        cuda_kernels.fir_down2d(torch.randn(1, 4, 8, 12, device=cuda_device),
                                *_fir_taps(), force_path="vector")
    with pytest.raises(ValueError, match="4 taps"):
        cuda_kernels.fir_down2d(x, [0.25] * 3, [0.25] * 4)
    # a plan that does not fit the tensor: the kernel's own checks refuse
    # it and nothing is launched (a grid one block off, a block past 256
    # threads, the vector path on a base 4 bytes past a 16-byte boundary)
    kern = cuda_kernels.fir_down2d
    plan = kern.plan(x)
    gx, gy = plan["grid"]
    odd = torch.randn(1 + x.numel(), device=cuda_device)[1:].view(x.shape)
    for bad, t in ((dict(plan, grid=(gx + 1, gy)), x),
                   (dict(plan, block=(257, 1)), x),
                   (dict(plan, path="vector"), odd)):
        with monkeypatch.context() as m:
            m.setattr(kern, "plan", lambda *_, bad=bad: bad)
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                kern(t, *_fir_taps())
    assert cuda_kernels.fir_down2d.launches == before


@pytest.mark.cuda
def test_ncsnpp_on_card_goes_through_kernel(cuda_device):
    """Every FIR downsample of a forward runs the kernel: 2 per down block
    plus 1 per input-pyramid level, and the card agrees with the CPU."""
    cfg = dict(nf=16, ch_mult=(1, 1, 1), num_res_blocks=1,
               attn_resolutions=(8,), image_size=32, num_channels_in=6,
               num_channels_out=4)
    model = NCSNpp(**cfg).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, 32, 64, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([0.3, 0.8])
    with torch.no_grad():
        want = model(x, t)
        model.to(cuda_device)
        before = cuda_kernels.fir_down2d.launches
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False  # full f32 for the compare
        try:
            got = model(x.to(cuda_device), t.to(cuda_device)).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    assert cuda_kernels.fir_down2d.launches - before == 3 * (3 - 1)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _fba_counts():
    return (cuda_kernels.fused_bias_act_fwd.launches,
            cuda_kernels.fused_bias_act_bwd.launches)


def _tolerance(ref, dtype, f32_rel=1e-6):
    peak = ref.float().abs().max().item()
    return f32_rel * peak if dtype == torch.float32 else bf16_ulp(peak)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [
    ((2, 4, 8, 128), -1), ((2, 4, 8, 128), 1),
    ((7919, 64), -1), ((7919, 64), 1),    # prime rows; axis 1 is last
    ((3, 5, 7, 9), 1), ((3, 5, 7, 9), -1),  # no 16-byte vectors
])
def test_fused_bias_act_kernels_match_plain(cuda_device, dtype, shape, axis):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(shape[axis], generator=g, device=cuda_device).to(dtype)
    gy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    fwd0, bwd0 = _fba_counts()
    y = cuda_kernels.fused_bias_act_fwd(x, b, 0.2, math.sqrt(2), axis)
    dx = cuda_kernels.fused_bias_act_bwd(x, b, gy, 0.2, math.sqrt(2), axis)
    torch.cuda.synchronize()
    assert _fba_counts() == (fwd0 + 1, bwd0 + 1)
    ref = cuda_kernels.fused_bias_act_plain(x, b, 0.2, math.sqrt(2), axis)
    dref = cuda_kernels.fused_bias_act_bwd_plain(x, b, gy, 0.2,
                                                 math.sqrt(2), axis)
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == shape
    assert (y.float() - ref.float()).abs().max() <= _tolerance(ref, dtype)
    assert (dx.float() - dref.float()).abs().max() <= _tolerance(dref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [-1, 1])
def test_fused_leaky_relu_autograd_on_card(cuda_device, axis):
    """Forward and backward both launch their kernel; gradients match the
    plain version's autograd on the CPU."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 8, 32, generator=gen)
    b = torch.randn(x.shape[axis], generator=gen)
    grads = []
    for dev in ("cpu", cuda_device):
        xd = x.to(dev).requires_grad_()
        bd = b.to(dev).requires_grad_()
        before = _fba_counts()
        out = fused_act.fused_leaky_relu(xd, bd, channel_axis=axis)
        gx, gb = torch.autograd.grad((out ** 2).sum(), (xd, bd))
        after = _fba_counts()
        want = (0, 0) if dev == "cpu" else (1, 1)
        assert (after[0] - before[0], after[1] - before[1]) == want
        grads.append((out.detach().cpu(), gx.cpu(), gb.cpu()))
    (o_c, gx_c, gb_c), (o_g, gx_g, gb_g) = grads
    assert (o_g - o_c).abs().max() <= 1e-6 * o_c.abs().max()
    assert (gx_g - gx_c).abs().max() <= 1e-5
    assert (gb_g - gb_c).abs().max() <= 1e-4 * gb_c.abs().max()
    # bias=None is a zero bias and still launches the kernel
    before = _fba_counts()
    y = fused_act.fused_leaky_relu(x.to(cuda_device), channel_axis=axis)
    assert _fba_counts()[0] == before[0] + 1
    assert torch.equal(y.cpu(), cuda_kernels.fused_bias_act_plain(
        x, torch.zeros(x.shape[axis]), channel_axis=axis))


@pytest.mark.cuda
def test_fused_bias_act_raises_not_falls_back(cuda_device):
    x = torch.randn(2, 8, 4, 16, device=cuda_device)
    b = torch.randn(16, device=cuda_device)
    before = _fba_counts()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_act.fused_leaky_relu(x.half(), b.half())
    with pytest.raises(ValueError, match="contiguous"):
        fused_act.fused_leaky_relu(x.transpose(1, 2).contiguous()
                                   .transpose(1, 2), b)
    with pytest.raises(ValueError, match="channel axis"):
        fused_act.fused_leaky_relu(x, b[:4], channel_axis=2)
    with pytest.raises(ValueError, match="bias"):
        fused_act.fused_leaky_relu(x, b[:8])
    with pytest.raises(ValueError, match="gradient"):
        cuda_kernels.fused_bias_act_bwd(x, b, x[:1])
    assert _fba_counts() == before


def _conv_case(device, b, h, w, c, c2, padw, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = 0.1 * torch.randn(b, h, w, c, generator=gen)
    w9 = 0.05 * torch.randn(9, c, c2, generator=gen)
    x = torch.nn.functional.pad(x, (0, 0, padw, padw, 1, 1))
    return (x.to(device=device, dtype=torch.bfloat16),
            w9.to(device=device, dtype=torch.bfloat16))


def _borders(y, padw):
    return torch.cat([y[:, :1].flatten(), y[:, -1:].flatten(),
                      y[:, :, :padw].flatten(), y[:, :, -padw:].flatten()])


_CONV_WRAPPERS = {"9tap": "conv3x3_9tap", "async_halo": "conv3x3_async_halo"}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    (k, s) for k in ("9tap", "async_halo") for s in (
        (1, 576, 256, 128, 128),   # the probe's conv at batch 1
        (2, 13, 37, 32, 48),       # ragged tiles, C2 not a multiple of 64
        (3, 8, 16, 16, 160),       # one tile, three output-channel slices
    )] + [
    ("9tap", (1, 21, 40, 288, 48)),         # the deepest C of PR 2's 9-tap
    ("async_halo", (2, 11, 45, 144, 160)),  # and of its async kernel
])
def test_conv3x3_kernels_match_plain(cuda_device, kernel, shape):
    b, h, w, c, c2 = shape
    padw = 1 if kernel == "9tap" else 4
    x, w9 = _conv_case(cuda_device, b, h, w, c, c2, padw)
    wrapper = getattr(cuda_kernels, _CONV_WRAPPERS[kernel])
    before = wrapper.launches
    y = (conv3x3.conv3x3_bordered(x, w9) if kernel == "9tap"
         else conv3x3.conv3x3_bordered_async(x, w9, padw))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = cuda_kernels.conv3x3_bordered_plain(x, w9, padw)
    assert y.shape == ref.shape == (b, h + 2, w + 2 * padw, c2)
    assert y.dtype == torch.bfloat16
    assert (y.float() - ref.float()).abs().max() <= _tolerance(
        ref, torch.bfloat16)
    assert bool((_borders(y, padw) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["9tap", "async_halo"])
@pytest.mark.parametrize("ctas", [1, 2, 7, None])
def test_conv3x3_cta_counts_give_same_bits(cuda_device, kernel, ctas):
    """H = 100, W = 20: 13 x 2 M tiles of 8 x 16 an image, 52 in all; C2 =
    160 is three slices of 64. One CTA walks all 156 items (the async
    ring of two stages wraps 156 times), 2 and 7 CTAs change slice between
    items (reloading their weights); each grid gives the bits of the
    plan's, within 1 ulp of the plain version. None: the plan's grid."""
    padw = 1 if kernel == "9tap" else 4
    x, w9 = _conv_case(cuda_device, 2, 100, 20, 128, 160, padw)
    wrapper = getattr(cuda_kernels, _CONV_WRAPPERS[kernel])
    before = wrapper.launches
    y = wrapper(x, w9, padw, ctas=ctas)
    want = wrapper(x, w9, padw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(y, want)
    ref = cuda_kernels.conv3x3_bordered_plain(x, w9, padw)
    assert (y.float() - ref.float()).abs().max() <= _tolerance(
        ref, torch.bfloat16)
    assert bool((_borders(y, padw) == 0).all())


@pytest.mark.cuda
def test_conv3x3_raises_not_falls_back(cuda_device):
    x, w9 = _conv_case(cuda_device, 1, 8, 16, 32, 32, 1)
    before = (cuda_kernels.conv3x3_9tap.launches,
              cuda_kernels.conv3x3_async_halo.launches)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3x3.conv3x3_bordered(x.float(), w9.float())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_bordered(x.transpose(1, 2).contiguous()
                                 .transpose(1, 2), w9)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv3x3.conv3x3_bordered(x[..., :24].contiguous(),
                                 w9[:, :24].contiguous())
    with pytest.raises(ValueError, match="multiples of 16"):
        conv3x3.conv3x3_bordered_async(x, w9[..., :8].contiguous(), 1)
    with pytest.raises(ValueError, match="padw"):
        cuda_kernels.conv3x3_9tap(x, w9, 2)
    with pytest.raises(ValueError, match="ctas"):
        cuda_kernels.conv3x3_async_halo(x, w9, 1, ctas=0)
    # past the plan's depth (9-tap C = 336, async C = 592) the weights,
    # halo and staging do not fit a block's shared memory even at 16
    # output channels a CTA: the wrapper raises before any launch
    for c, padw, fn in ((336, 1, conv3x3.conv3x3_bordered),
                        (592, 4, conv3x3.conv3x3_bordered_async)):
        xd, wd = _conv_case(cuda_device, 1, 8, 16, c, 16, padw)
        with pytest.raises(ValueError, match="shared memory"):
            fn(xd, wd)
    assert (cuda_kernels.conv3x3_9tap.launches,
            cuda_kernels.conv3x3_async_halo.launches) == before


# ------------------------------------ fir_up2d: fir_down2d's backward ------
def _fir_up_case(device, shape, dtype, channels_last, seed=0):
    """g (N, C, H//2, W//2) on the card for an input of ``shape``."""
    n, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n, c, h // 2, w // 2), generator=gen,
                    device=device).to(dtype)
    if channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,k,gain", [
    ((2, 8, 64, 144), (1, 3, 3, 1), 1.0),
    ((1, 6, 17, 9), (1, 2, 3, 4), 2.5),   # odd sizes, asymmetric kernel
    ((3, 5, 2, 2), (1, 3, 3, 1), 1.0),    # the smallest input
    ((2, 16, 8, 24), (1, 3, 3, 1), 1.0),  # the train path's deepest level
    ((2, 4, 12, 40), (1, 2, 3, 4), 2.5),  # W % 16 != 0: bf16 scalar
    ((1, 24, 33, 47), (1, 3, 3, 1), 1.0),  # odd H and W, C % 8 == 0
    ((1, 3, 10, 1200), (1, 3, 3, 1), 1.0),  # several column tiles a row
    ((6, 128, 256, 384), (1, 3, 3, 1), 1.0),  # level 0 of the train path
])
def test_fir_up2d_matches_plain(cuda_device, dtype, channels_last, shape, k,
                                gain):
    """The same bits as the plain version (its order, no FMA), so within
    f32 1e-6 and bf16 1 ulp; dx in g's layout and dtype."""
    g = _fir_up_case(cuda_device, shape, dtype, channels_last)
    taps = cuda_kernels.separable_taps(np.asarray(k, np.float64), gain)
    before = cuda_kernels.fir_up2d.launches
    dx = cuda_kernels.fir_up2d(g, *taps, shape[2:])
    torch.cuda.synchronize()
    assert cuda_kernels.fir_up2d.launches == before + 1
    ref = cuda_kernels.downsample_2d_bwd_plain(g, k, shape[2:], gain)
    assert dx.shape == shape and dx.dtype == dtype
    layout_cl = cuda_kernels.fir_up2d.plan(g, shape[2:])["layout"] \
        == "channels_last"
    assert dx.is_contiguous(memory_format=torch.channels_last
                            if layout_cl else torch.contiguous_format)
    assert (dx.float() - ref.float()).abs().max() <= _tolerance(ref, dtype)
    assert torch.equal(dx, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last,shape", [
    (False, (2, 8, 64, 144)), (False, (6, 128, 256, 384)),
    (True, (2, 32, 20, 36)), (True, (1, 16, 17, 9)),
])
def test_fir_up2d_paths_give_same_bits(cuda_device, dtype, channels_last,
                                       shape):
    g = _fir_up_case(cuda_device, shape, dtype, channels_last, seed=1)
    kern = cuda_kernels.fir_up2d
    assert kern.plan(g, shape[2:])["path"] == "vector"
    vec = kern(g, *_fir_taps(), shape[2:], force_path="vector")
    sca = kern(g, *_fir_taps(), shape[2:], force_path="scalar")
    torch.cuda.synchronize()
    assert torch.equal(vec, sca)


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
def test_fir_up2d_misaligned_and_many_planes(cuda_device, channels_last):
    """A base 4 bytes past a 16-byte boundary takes the scalar path (the
    vector one raises); 70,000 planes or images loop gridDim.y."""
    shape = (2, 16, 12, 32)
    g = _fir_up_case(cuda_device, shape, torch.float32, channels_last)
    buf = torch.empty(g.numel() + 1, device=cuda_device)
    if channels_last:
        n, c, h, w = g.shape
        odd = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    else:
        odd = buf[1:].view(g.shape)
    odd.copy_(g)
    assert odd.data_ptr() % 16 != 0
    assert cuda_kernels.fir_up2d.plan(odd, shape[2:])["path"] == "scalar"
    with pytest.raises(ValueError, match="vector path"):
        cuda_kernels.fir_up2d(odd, *_fir_taps(), shape[2:],
                              force_path="vector")
    assert torch.equal(cuda_kernels.fir_up2d(odd, *_fir_taps(), shape[2:]),
                       cuda_kernels.fir_up2d(g, *_fir_taps(), shape[2:]))
    big = (70000, 8, 4, 6) if channels_last else (2, 35000, 4, 16)
    gb = _fir_up_case(cuda_device, big, torch.float32, channels_last)
    assert cuda_kernels.fir_up2d.plan(gb, big[2:])["grid"][1] == 65535
    dx = cuda_kernels.fir_up2d(gb, *_fir_taps(), big[2:])
    torch.cuda.synchronize()
    assert torch.equal(dx, cuda_kernels.downsample_2d_bwd_plain(
        gb, [1, 3, 3, 1], big[2:]))


@pytest.mark.cuda
def test_fir_up2d_raises_not_falls_back(cuda_device, monkeypatch):
    g = torch.randn(1, 4, 4, 4, device=cuda_device)
    kern = cuda_kernels.fir_up2d
    before = kern.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern(g.cpu(), *_fir_taps(), (8, 8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kern(g.half(), *_fir_taps(), (8, 8))
    with pytest.raises(ValueError, match="does not fit"):
        kern(g, *_fir_taps(), (10, 8))
    with pytest.raises(ValueError, match="strides"):
        kern(g.transpose(2, 3), *_fir_taps(), (8, 8))
    with pytest.raises(ValueError, match="4 taps"):
        kern(g, [0.25] * 3, [0.25] * 4, (8, 8))
    plan = kern.plan(g, (8, 8))
    gx, gy = plan["grid"]
    for bad in (dict(plan, grid=(gx + 1, gy)), dict(plan, block=(257, 1))):
        with monkeypatch.context() as m:
            m.setattr(kern, "plan", lambda *_, bad=bad: bad)
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                kern(g, *_fir_taps(), (8, 8))
    assert kern.launches == before


@pytest.mark.cuda
def test_failed_build_raises(cuda_device, tmp_path, monkeypatch):
    """A source nvcc refuses raises with its log; nothing is loaded."""
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", tmp_path)
    lib = cuda_kernels.CudaLibrary(
        "fir_up2d.cu", edits=[('extern "C" int fir_up2d(',
                               'extern "C" int fir_up2d(not_a_type ')])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        lib.load()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_downsample_2d_gradient_on_card(cuda_device, dtype, channels_last):
    """On the card, x.grad through ops.fir.downsample_2d equals the plain
    version's, by fir_up2d; without a wanted gradient the kernel is called
    directly and the output has no grad_fn."""
    x0 = torch.randn(2, 8, 17, 40, generator=torch.Generator().manual_seed(4))
    x0 = x0.to(dtype)
    gy = torch.randn(2, 8, 8, 20, generator=torch.Generator().manual_seed(5))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = x0.to(cuda_device).contiguous(memory_format=fmt).requires_grad_()
    counts = (cuda_kernels.fir_down2d.launches, cuda_kernels.fir_up2d.launches)
    y = fir.downsample_2d(x, [1, 3, 3, 1])
    assert y.grad_fn is not None
    y.backward(gy.to(cuda_device, dtype))
    torch.cuda.synchronize()
    assert (cuda_kernels.fir_down2d.launches - counts[0],
            cuda_kernels.fir_up2d.launches - counts[1]) == (1, 1)
    want = cuda_kernels.downsample_2d_bwd_plain(gy.to(cuda_device, dtype),
                                                [1, 3, 3, 1], (17, 40))
    assert torch.equal(x.grad, want)
    # the CPU's autograd of the plain version agrees (f32)
    if dtype == torch.float32:
        xc = x0.clone().requires_grad_()
        fir.downsample_2d(xc, [1, 3, 3, 1]).backward(gy)
        assert (x.grad.cpu() - xc.grad).abs().max() <= 1e-6
    # a gradient in neither layout (expanded ones) is made contiguous
    x.grad = None
    fir.downsample_2d(x, [1, 3, 3, 1]).sum().backward()
    assert torch.equal(x.grad, cuda_kernels.downsample_2d_bwd_plain(
        torch.ones(2, 8, 8, 20, device=cuda_device, dtype=dtype),
        [1, 3, 3, 1], (17, 40)))
    with torch.no_grad():
        assert fir.downsample_2d(x, [1, 3, 3, 1]).grad_fn is None
    assert fir.downsample_2d(x.detach(), [1, 3, 3, 1]).grad_fn is None


@pytest.mark.cuda
def test_ncsnpp_backward_on_card_goes_through_kernels(cuda_device):
    """Backward through NCSN++ launches fir_up2d for both downsamples of
    every down block (h and the skip x), none for the input pyramid (it
    acts on data), and the card's gradients match the CPU's (TF32 off)."""
    cfg = dict(nf=16, ch_mult=(1, 1, 1), num_res_blocks=1,
               attn_resolutions=(8,), image_size=32, num_channels_in=6,
               num_channels_out=4)
    model = NCSNpp(**cfg).train()
    model.reset_parameters(torch.Generator().manual_seed(0))
    for m in model.modules():  # give the zero-init layers real weights
        if getattr(m, "init_scale", None) == 0.0:
            m.init_scale = 1.0
            m.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(2, 6, 32, 64, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([0.3, 0.8])
    grads = []
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda_device):
            model.to(dev)
            model.zero_grad()
            before = (cuda_kernels.fir_down2d.launches,
                      cuda_kernels.fir_up2d.launches)
            (model(x.to(dev), t.to(dev)) ** 2).mean().backward()
            torch.cuda.synchronize()
            after = (cuda_kernels.fir_down2d.launches,
                     cuda_kernels.fir_up2d.launches)
            want = (0, 0) if dev == "cpu" else (3 * 2, 2 * 2)
            assert (after[0] - before[0], after[1] - before[1]) == want
            grads.append({k: p.grad.detach().cpu().clone()
                          for k, p in model.named_parameters()})
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    top = max(g.abs().max() for g in grads[0].values())
    for k, g in grads[0].items():
        if k.endswith("NIN_1.b"):
            # the attention's key bias: softmax is invariant to it, its
            # exact gradient is 0 and both devices give round-off
            assert max(g.abs().max(), grads[1][k].abs().max()) <= 1e-6 * top
        else:
            assert ((grads[1][k] - g).abs().max()
                    <= 1e-4 * g.abs().max() + 1e-9), k


@pytest.mark.cuda
def test_flagship_width_train_step_is_finite(cuda_device):
    """One train step of the nf=128 diffsep_icassp score model on the card
    (batch 2 x 2.048 s), through the kernels of both passes."""
    from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep_icassp
    trainer = build_diffsep_trainer(diffsep_icassp(), device=cuda_device)
    state = trainer.init_state()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tgt = 0.1 * torch.randn(2, 2, 16384, generator=gen, device=cuda_device)
    counts = (cuda_kernels.fir_down2d.launches, cuda_kernels.fir_up2d.launches)
    state, m = trainer.train_step(state, (tgt.sum(1, keepdim=True), tgt),
                                  generator=gen)
    torch.cuda.synchronize()
    assert (cuda_kernels.fir_down2d.launches - counts[0],
            cuda_kernels.fir_up2d.launches - counts[1]) == (36, 24)
    assert math.isfinite(m["train/score_loss"].item())
    assert math.isfinite(m["train/grad_norm"].item())
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


class _full_f32:
    """cuDNN convs and matmuls in full float32 inside the block."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [(7, 10), (1, 10), (10, 10)])
def test_masked_group_norm_on_card(cuda_device, valid):
    """The masked GroupNorm (statistics over the valid frames) on the card
    against the CPU, 1e-5 abs."""
    from ditsep_tpu_torch.models import layers
    g = torch.Generator().manual_seed(sum(valid))
    x = 3.0 * torch.randn(2, 64, 6, 10, generator=g) + 1.5
    mask = layers.time_mask_to_gn(
        torch.arange(10)[None, :] < torch.tensor(valid)[:, None])
    gn = layers.group_norm(64)
    with torch.no_grad():
        gn.weight.copy_(torch.randn(64, generator=g))
        gn.bias.copy_(torch.randn(64, generator=g))
        want = gn(x, mask)
        got = gn.to(cuda_device)(x.to(cuda_device), mask.to(cuda_device))
    assert (got.cpu() - want).abs().max() <= 1e-5


def _masked_ckpt_trainer(device):
    import os
    from ditsep_tpu_torch.configs import (build_diffsep_trainer, diffsep,
                                          override)
    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "examples", "checkpoints", "masked_synthetic_ema.npz")
    cfg = override(diffsep(), {
        "model.score_model.nf": 32, "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,),
        "model.score_model.mask_padding": True})
    return build_diffsep_trainer(cfg, device=device, params_npz=ckpt)


@pytest.mark.cuda
def test_masked_score_model_on_card(cuda_device):
    """The mask-trained checkpoint run masked, with per-item lengths, on
    the card (TF32 off) against the CPU: 1e-4 * max|ref|."""
    g = torch.Generator().manual_seed(3)
    xt, mix = torch.randn(2, 2, 6000, generator=g), torch.randn(
        2, 1, 6000, generator=g)
    t, lens = torch.tensor([0.4, 0.9]), torch.tensor([6000, 3500])
    with torch.no_grad():
        want = _masked_ckpt_trainer("cpu").model(xt, t, mix, lengths=lens)
        model = _masked_ckpt_trainer(cuda_device).model
        with _full_f32():
            got = model(xt.to(cuda_device), t.to(cuda_device),
                        mix.to(cuda_device),
                        lengths=lens.to(cuda_device)).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_masked_separate_launches_follow_the_plan(cuda_device):
    """A masked separate with lengths launches fir_down2d 9 times a score
    call (nf=32, 4 levels: 3 down blocks x 2 + 3 pyramid levels), 2N
    calls."""
    trainer = _masked_ckpt_trainer(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mix = 0.1 * torch.randn(3, 1, 7000, generator=gen, device=cuda_device)
    before = cuda_kernels.fir_down2d.launches
    est, nfe = trainer.separate(mix, N=3, generator=gen,
                                lengths=torch.tensor([7000, 5000, 100],
                                                     device=cuda_device))
    torch.cuda.synchronize()
    assert nfe == 6 and est.shape == (3, 2, 7000)
    assert cuda_kernels.fir_down2d.launches - before == 9 * nfe
    assert bool(torch.isfinite(est).all())


def _family_trainer(family, device):
    """``family``'s config at nf=32 with 4 levels, seeded weights with the
    zero-init layers at unit scale, on ``device``."""
    from ditsep_tpu_torch.configs import (
        CONFIG_FAMILIES, build_diffsep_trainer, override,
    )
    cfg = override(CONFIG_FAMILIES[family](), {
        "model.score_model.nf": 32,
        "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,)})
    trainer = build_diffsep_trainer(cfg, device="cpu", seed=0)
    for m in trainer.model.modules():
        if getattr(m, "init_scale", None) == 0.0:
            m.init_scale = 1.0
            m.reset_parameters(torch.Generator().manual_seed(1))
    trainer.model.to(device)
    return trainer


@pytest.mark.cuda
@pytest.mark.parametrize("family,sampler,sampler_type,n", [
    ("diffsep_ouve", "pc", None, 3),
    ("enhancement", "pc", None, 3),
    ("diffsep", "ab2", None, 3),
    ("diffsep_sb", "pc", "ode", 1),  # past step 1 the bridge scales
    ("diffsep_sb", "pc", "sde", 3),  # round-off by thousands
])
def test_family_separate_on_card(cuda_device, family, sampler, sampler_type,
                                 n):
    """Each new family's separation on the card (TF32 off) against the
    CPU with the same explicit noise: 1e-3 relative at the waveform, the
    same NFE, 9 fir_down2d launches a score call on the card."""
    import dataclasses
    fs = 16000 if family == "enhancement" else 8000
    rng = np.random.default_rng(5)
    mix = (0.1 * rng.standard_normal((1, 1, fs))).astype(np.float32)
    shape = (1, 2, fs)
    z = lambda *lead: rng.standard_normal(lead + shape).astype(  # noqa
        np.float32)
    noise = {"pc": (z(), z(n, 1), z(n)), "ab2": (z(), None)}[sampler]
    if family == "diffsep_sb":
        noise = z(n) if sampler_type == "sde" else None
    out = {}
    for dev in ("cpu", cuda_device):
        trainer = _family_trainer(family, dev)
        if sampler_type is not None:
            trainer = dataclasses.replace(trainer, sde=dataclasses.replace(
                trainer.sde, sampler_type=sampler_type))
        before = cuda_kernels.fir_down2d.launches
        with _full_f32():
            est, nfe = trainer.separate(torch.from_numpy(mix).to(dev), N=n,
                                        sampler=sampler, noise=noise)
        torch.cuda.synchronize()
        out[str(dev)] = (est.cpu(), nfe,
                         cuda_kernels.fir_down2d.launches - before)
    (want, nfe_cpu, l_cpu), (got, nfe_card, l_card) = out.values()
    assert nfe_card == nfe_cpu and l_cpu == 0 and l_card == 9 * nfe_card
    assert got.shape == shape and bool(torch.isfinite(got).all())
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.cuda
def test_edm_train_step_gradient_on_card(cuda_device):
    """The EDM loss of diffsep_sb (init hack 5, p 0: both forwards run,
    the t=T PIT one masked out) on the card (TF32 off): its backward
    launches fir_up2d 6 times (3 down blocks x h and the skip x) for each
    of the two forwards, and its gradient matches the CPU's, each leaf
    within 1e-3 of its own max|ref|."""
    rng = np.random.default_rng(6)
    tgt = (0.3 * rng.standard_normal((2, 2, 8000))).astype(np.float32)
    mix = tgt.sum(1, keepdims=True)
    draws = {"mask_u": np.array([0.05, 0.5], np.float32),
             "pit_z": rng.standard_normal(tgt.shape).astype(np.float32),
             "shuffle_u": rng.random((2, 2)).astype(np.float32),
             "time_u": rng.random(2).astype(np.float32),
             "z": rng.standard_normal(tgt.shape).astype(np.float32)}
    grads = []
    for dev in ("cpu", cuda_device):
        trainer = _family_trainer("diffsep_sb", dev)
        named = dict(trainer.model.named_parameters())
        before = cuda_kernels.fir_up2d.launches
        with _full_f32():
            loss = trainer.training_loss(
                trainer.model, torch.from_numpy(mix).to(dev),
                torch.from_numpy(tgt).to(dev), draws=draws)
            g = torch.autograd.grad(loss, list(named.values()))
        torch.cuda.synchronize()
        launches = cuda_kernels.fir_up2d.launches - before
        assert launches == (0 if str(dev) == "cpu" else 2 * 6)
        assert bool(torch.isfinite(loss))
        grads.append({k: v.cpu() for k, v in zip(named, g)})
    top = max(v.abs().max() for v in grads[0].values())
    for k, want in grads[0].items():
        got = grads[1][k]
        if k.endswith("NIN_1.b"):  # the attention's key bias: exactly 0
            assert max(want.abs().max(), got.abs().max()) <= 1e-6 * top
        else:
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,tl", [(1, 36), (4, 36), (1, 20), (16, 20)])
def test_fir_kernels_at_latent_shapes_match_plain(
        cuda_device, dtype, batch, tl):
    """The latent U-Net's fir_down2d inputs (36 and 20 latent frames: no
    width a multiple of 2V = 8 / 16) and their gradients: fir_down2d on
    the scalar path; fir_up2d on its vector path where W is a multiple of
    its 2V = 4 (f32) / 8 (bf16) and there equal to its scalar path; both
    the plain versions' bits."""
    from ditsep_tpu_torch.scripts.fir_timing import latent_path_shapes
    k = (1, 3, 3, 1)
    taps = _fir_taps()
    g = torch.Generator(device=cuda_device).manual_seed(tl)
    up_v = 2 if dtype == torch.float32 else 4
    for _, _, shape in latent_path_shapes(batch, tl):
        x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
        assert cuda_kernels.fir_down2d.plan(x)["path"] == "scalar"
        y = cuda_kernels.fir_down2d(x, *taps)
        assert torch.equal(y, cuda_kernels.downsample_2d_plain(x, k))
        gy = torch.randn(y.shape, generator=g, device=cuda_device).to(dtype)
        hw = tuple(shape[2:])
        path = cuda_kernels.fir_up2d.plan(gy, hw)["path"]
        assert path == ("vector" if hw[1] % (2 * up_v) == 0 else "scalar")
        dx = cuda_kernels.fir_up2d(gy, *taps, hw)
        assert torch.equal(dx, cuda_kernels.downsample_2d_bwd_plain(
            gy, k, hw))
        assert torch.equal(dx, cuda_kernels.fir_up2d(gy, *taps, hw,
                                                     force_path="scalar"))


@pytest.mark.cuda
def test_oobleck_vae_on_card_matches_cpu(cuda_device):
    """A small OobleckVAE with seeded weights: encode (the mode, and a
    posterior sample with one draw) and decode on the card, TF32 off,
    within 1e-5 of max|CPU|."""
    from ditsep_tpu_torch.models import OobleckVAE
    vae = OobleckVAE(channels=16, c_mults=(1, 2, 4), strides=(2, 4, 8),
                     latent_dim=8, use_snake=True)
    vae.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in vae.parameters():  # snake off its zero init
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(p.numel())))
    g = torch.Generator().manual_seed(1)
    audio = 0.3 * torch.randn(2, 1, 4096, generator=g)
    z = torch.randn(2, 8, 64, generator=g)
    lat = torch.randn(2, 8, 32, generator=g)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want = (vae.encode(audio), vae.encode(audio, noise=z),
                    vae.decode(lat))
            vae.to(cuda_device)
            got = (vae.encode(audio.to(cuda_device)),
                   vae.encode(audio.to(cuda_device), noise=z.to(cuda_device)),
                   vae.decode(lat.to(cuda_device)))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert (a.cpu() - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
def test_engine_serves_on_card_and_matches_cpu(cuda_device):
    """cli.serve_api.build_engine on the card at nf=32 (the trained
    checkpoint, masked, TF32 off) serves two concurrent requests in one
    batch; fir_down2d launches batches x NFE x 9; the served stems match
    the CPU given the engine's draws (replayed by pc_generator_noise)
    within 1e-3 relative."""
    import os
    import threading

    from ditsep_tpu_torch.cli.serve_api import build_engine
    from ditsep_tpu_torch.configs import diffsep, override
    from ditsep_tpu_torch.sdes.samplers import pc_generator_noise

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "examples", "checkpoints", "masked_synthetic_ema.npz")
    cfg = override(diffsep(), {
        "model.score_model.nf": 32, "model.score_model.ch_mult": (1, 1, 2, 2),
        "model.score_model.attn_resolutions": (32,)})
    n, seed, lengths = 3, 11, (6000, 5200)
    rng = np.random.default_rng(6)
    audios = [(0.1 * rng.standard_normal(L)).astype(np.float32)
              for L in lengths]
    served = [None, None]
    with _full_f32():
        eng = build_engine(cfg, device=cuda_device, params_npz=ckpt,
                           sampler_N=n, mask_padding=True, max_batch=2,
                           max_wait_ms=2000.0, seed=seed)
        before = cuda_kernels.fir_down2d.launches
        try:
            def post(i):
                served[i] = eng.separate(audios[i], timeout=120)

            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            st = eng.stats()
        finally:
            eng.close()
        torch.cuda.synchronize()
        launches = cuda_kernels.fir_down2d.launches - before
        assert st["batches"] == 1 and st["batched_items"] == 2
        assert eng.separate_fn.nfe == 2 * n
        assert launches == st["batches"] * eng.separate_fn.nfe * 9
        blen = eng.bucket_of(max(lengths))
        mix = np.zeros((2, 1, blen), np.float32)
        for i, a in enumerate(audios):
            mix[i, 0, :a.shape[-1]] = a
        noise = tuple(t.cpu() for t in pc_generator_noise(
            torch.Generator(device=cuda_device).manual_seed(seed),
            (2, 2, blen), n))
        cpu = _masked_ckpt_trainer("cpu")
        want, _ = cpu.separate(torch.from_numpy(mix), N=n, noise=noise,
                               lengths=torch.tensor(lengths))
    for i, got in enumerate(served):
        ref = want[i, :, :lengths[i]].numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.cuda
def test_kernel_launches_on_a_card_that_is_not_current(cuda_device):
    """The wrappers launch under ``torch.cuda.device(x.device)``: a tensor
    on card 1 while card 0 is current. No chip run so far had two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (every chip run so far had one)")
    torch.cuda.set_device(0)
    g = torch.Generator(device="cuda:1").manual_seed(0)
    x = torch.randn((2, 8, 64, 144), generator=g, device="cuda:1")
    before = cuda_kernels.fir_down2d.launches
    y = fir.downsample_2d(x, (1, 3, 3, 1), 2, 1.0)
    torch.cuda.synchronize(1)
    assert cuda_kernels.fir_down2d.launches == before + 1
    assert y.device == x.device and torch.cuda.current_device() == 0
    ref = cuda_kernels.downsample_2d_plain(x, (1, 3, 3, 1), 2, 1.0)
    assert (y - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


def _card_ranks_worker(mesh, out, draws):
    from test_torch_parallel import diffsep_case
    with _full_f32():
        res = diffsep_case(mesh, draws)
    if mesh.rank == 0:
        torch.save(res, out)


@pytest.mark.cuda
def test_two_gloo_ranks_share_one_card(cuda_device, tmp_path):
    """A waveform train step over two gloo ranks both on cuda:0 (the
    fir_down2d and fir_up2d kernels in each) against the one-process
    step on the card, at the train-step bars (tests/test_torch_parallel.py)."""
    from ditsep_tpu_torch import parallel
    from test_torch_parallel import (
        all_draws, check_grads, check_step, diffsep_case,
    )
    draws = all_draws()["diffsep"]
    out = tmp_path / "two.pt"
    parallel.launch(_card_ranks_worker, 2, str(out), draws,
                    device="cuda:0", backend="gloo", timeout_s=300)
    two = torch.load(out, weights_only=False)
    with _full_f32():
        one = diffsep_case(None, draws, device=cuda_device)
    check_grads(two["grads"], one["grads"], "two gloo ranks on cuda:0")
    check_step(two, one, one["grads"], one["lr"], one["decay"],
               "two gloo ranks on cuda:0")


@pytest.mark.cuda
def test_engine_over_cards_gives_the_plain_engines_stems(cuda_device):
    """``BatchingEngine(mesh=make_mesh())`` over every local card (a
    replica a card, each in its own thread, its generator a copy of
    cuda:0's) serves one batch of 2 rows a card, a padded row among them.
    The whole batch equals the plain engine on cuda:0 within 1e-6 of its
    max (cuDNN may round a batch of 2 otherwise than a batch of 2n), and
    each replica's stems equal bit for bit its rows separated on its own
    card, in this thread, from the engine's first generator state (the
    thread and the copied generator change nothing). TF32 off,
    deterministic cuDNN. Against its rows separated on cuda:0 the last
    card's differed by 1 ulp in 1 and then 89 elements in two four-card
    runs (those of cards 1-2 were equal): prints each card's largest
    difference from cuda:0. Skips below two cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards (every chip run so far had one)")
    from ditsep_tpu_torch import parallel
    from ditsep_tpu_torch.scripts import dryrun_multichip as dry

    torch.cuda.set_device(0)
    trainer = dry.diffsep_trainer("cuda:0")
    rng = np.random.default_rng(9)
    audios = [rng.standard_normal(3000 + 100 * i).astype(np.float32)
              for i in range(2 * n - 1)]
    mesh = parallel.make_mesh()
    assert mesh.devices.size == n and mesh.world_size == 1
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        (plain, served), own, card0 = _serve_over_cards(trainer, audios,
                                                        mesh, n)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    for i, a in enumerate(audios):
        L = a.shape[-1]
        assert served[i].shape == (2, L) and np.isfinite(served[i]).all()
        top = np.abs(plain[i]).max()
        assert np.abs(served[i] - plain[i]).max() <= 1e-6 * top, i
    for k in range(n):
        rows = range(2 * k, min(2 * k + 2, len(audios)))
        d0 = max(float(np.abs(served[i] - card0[i, :, :audios[i].shape[-1]])
                       .max()) for i in rows)
        print(f"card {k}: largest difference from cuda:0's rows {d0}")
    for i, a in enumerate(audios):
        diff = np.abs(served[i] - own[i, :, :a.shape[-1]])
        assert diff.max() == 0, (i, int((diff > 0).sum()), float(diff.max()))


def _serve_over_cards(trainer, audios, mesh, n):
    """The stems of the plain engine and of the engine over ``mesh``, and
    each replica's rows separated from the engine's first generator state
    on its own card and on cuda:0."""
    from ditsep_tpu_torch import parallel
    from ditsep_tpu_torch.cli.serve_api import TrainerSeparator
    from ditsep_tpu_torch.serving import BatchingEngine

    outs = []
    sep = TrainerSeparator(trainer, latent=False, N=2, sampler="pc")
    with _full_f32():
        for m in (None, mesh):
            eng = BatchingEngine(sep, max_batch=2 * n, max_wait_ms=2000.0,
                                 device="cuda:0", mesh=m, seed=3)
            try:
                assert eng.batch_sizes[-1] == 2 * n
                futs = [eng.submit(a) for a in audios]
                outs.append([f.result(timeout=300) for f in futs])
                st = eng.stats()
                assert st["batches"] == 1 and st["padded_rows"] == 1
                blen = eng.bucket_of(max(a.shape[-1] for a in audios))
            finally:
                eng.close()
        mix = np.zeros((2 * n, 1, blen), np.float32)
        for i, a in enumerate(audios):
            mix[i, 0, :a.shape[-1]] = a
        start = torch.Generator(device="cuda:0").manual_seed(3).get_state()
        refs = {"own": [], "card0": []}
        for k in range(n):
            for name, dev in (("own", mesh.local[k]),
                              ("card0", torch.device("cuda:0"))):
                g = torch.Generator(device=dev)
                g.set_state(start)
                x = torch.from_numpy(mix[2 * k:2 * k + 2]).to(dev)
                rep = sep if dev == torch.device("cuda:0") else (
                    sep.replicate(dev))
                with torch.inference_mode(), parallel.sharded(
                        mesh, index=k, count=n):
                    est = rep(x, generator=g)
                refs[name].append(est.float().cpu().numpy())
    return (outs, np.concatenate(refs["own"]),
            np.concatenate(refs["card0"]))


@pytest.mark.cuda
def test_reference_checkpoint_imports_on_the_card(cuda_device, tmp_path):
    """A Lightning-layout checkpoint (the score network under
    ``score_model.backbone.``, the sigmas buffer, torch_ema's shadows in
    parameter order) loads into a model on the card with the shadows bit
    for bit, and the card's separation with matched noise equals the
    CPU's within 1e-3 of max|ref| (TF32 off), the card's launching
    fir_down2d on every score evaluation."""
    from ditsep_tpu_torch.configs import (
        build_diffsep_trainer, diffsep, override,
    )
    from ditsep_tpu_torch.models import import_diffsep_ema
    cfg = override(diffsep(), {"model.score_model.nf": 16,
                               "model.score_model.ch_mult": (1, 1, 1),
                               "model.score_model.num_res_blocks": 1,
                               "model.score_model.attn_resolutions": ()})
    src = build_diffsep_trainer(cfg, device="cpu", seed=0).model.backbone
    sd = {"score_model.backbone.sigmas": torch.linspace(0.05, 0.5, 10)}
    sd.update({f"score_model.backbone.{k}": v
               for k, v in src.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    names = [k for k, _ in src.named_parameters()]
    shadows = [p.detach() + 0.01 * torch.randn(p.shape, generator=g)
               for _, p in src.named_parameters()]
    torch.save({"state_dict": sd, "ema": {"shadow_params": shadows}},
               tmp_path / "ref.ckpt")
    ckpt = torch.load(tmp_path / "ref.ckpt", weights_only=False)
    tr = {d: build_diffsep_trainer(cfg, device=d, seed=2)
          for d in ("cpu", "cuda")}
    for t in tr.values():
        import_diffsep_ema(t.model, ckpt)
    got = tr["cuda"].model.backbone.state_dict()
    for k, s in zip(names, shadows):
        assert torch.equal(got[k].cpu(), s), k
    rng = np.random.default_rng(3)
    mix = rng.standard_normal((2, 1, 1500)).astype(np.float32)
    noise = (rng.standard_normal((2, 2, 1500)).astype(np.float32),
             rng.standard_normal((2, 1, 2, 2, 1500)).astype(np.float32),
             rng.standard_normal((2, 2, 2, 1500)).astype(np.float32))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for d, t in tr.items():
            before = cuda_kernels.fir_down2d.launches
            est, nfe = t.separate(torch.from_numpy(mix).to(d), N=2, noise=[
                torch.from_numpy(z).to(d) for z in noise])
            out[d] = est.cpu().numpy()
            launched = cuda_kernels.fir_down2d.launches - before
        assert launched > 0 and launched % nfe == 0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    ref = out["cpu"]
    assert np.abs(out["cuda"] - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.mark.cuda
def test_full_width_dit_on_card_matches_cpu(cuda_device):
    """Stable Audio Open 1.0's DiT (1536 wide, 24 layers, 1.09 B
    parameters) with seeded weights, its zero-initialised layers redrawn:
    one CFG forward (2 rows x 1,025 tokens, a 130-token context and the
    global conditioning) on the card equals the CPU's within 1e-3 of
    max|cpu|, TF32 off."""
    import copy

    from ditsep_tpu_torch.models.factory import (
        create_diffusion_cond_from_config)

    from chip_smoke import SAO_FULL, nonzero_

    with torch.device("meta"):
        dit = create_diffusion_cond_from_config(SAO_FULL)[0]
    dit = dit.to_empty(device="cpu")
    dit.reset_parameters(torch.Generator().manual_seed(0))
    nonzero_(dit, 1)
    dit.eval()
    card = copy.deepcopy(dit).to(cuda_device)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 64, 1024, generator=g)
    t = torch.full((1,), 0.6)
    cond = {"cross_attn_cond": torch.randn(1, 130, 768, generator=g),
            "global_embed": torch.randn(1, 1536, generator=g)}
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = dit(x, t, cfg_scale=7.0, **cond)
            got = card(x.to(cuda_device), t.to(cuda_device), cfg_scale=7.0,
                       **{k: v.to(cuda_device) for k, v in cond.items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert got.shape == want.shape == (1, 64, 1024)
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= 1e-3, float(err)


@pytest.mark.cuda
def test_full_width_lm_cached_step_matches_full_pass(cuda_device):
    """The token LM at MusicGen-small's widths (1024 x 24 layers, 16
    heads, 9 codebooks of 1024, 0.42 B parameters), seeded, its
    zero-initialised layers redrawn: the last of 40 cached decode steps
    (one token a step into the preallocated cache) against one full
    uncached pass over the same prefix on the card, within 1e-4 of
    max|ref|, TF32 off."""
    from ditsep_tpu_torch.models.factory import create_model_from_config

    from chip_smoke import LM_FULL, lm_teacher_forced, nonzero_

    with torch.device(cuda_device):
        lm, pattern = create_model_from_config(
            LM_FULL, torch.Generator(device=cuda_device).manual_seed(0))
    nonzero_(lm, 1)
    lm.eval()
    g = torch.Generator(device=cuda_device).manual_seed(2)
    codes = torch.randint(0, 1024, (1, 9, 32), generator=g,
                          device=cuda_device)
    grid = pattern.apply(codes)
    bos = torch.full((1, 9, 1), lm.special_token, device=cuda_device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            cached = lm_teacher_forced(lm, grid, {}, 1.0)[:, :, -1]
            full = lm(torch.cat([bos, grid[..., :-1]], dim=-1))[:, :, -1]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert grid.shape[-1] == 40 and cached.shape == (1, 9, 1024)
    err = (cached - full).abs().max() / full.abs().max()
    assert err <= 1e-4, float(err)


@pytest.mark.cuda
def test_stable_train_lm_step_on_card(cuda_device):
    """``LMTrainer`` at MusicGen-small's widths (0.42 B parameters) takes
    one step on the card (batch 2 x 64 frames): the loss and grad norm
    finite, no kernel launched; the small LM's two steps (the clip on) on
    the card against the CPU at the train-step bars, TF32 off
    (chip_smoke.trainer_card_vs_cpu)."""
    import copy

    from ditsep_tpu_torch.models.factory import create_model_from_config
    from ditsep_tpu_torch.models.lm import AudioLM
    from ditsep_tpu_torch.training.lm import LMTrainer

    from chip_smoke import (
        LM_FULL, STABLE_LM_SMALL, counts, full_f32, nonzero_, reset_counts,
        trainer_card_vs_cpu,
    )

    with torch.device(cuda_device):
        lm, _ = create_model_from_config(
            LM_FULL, torch.Generator(device=cuda_device).manual_seed(0))
    nonzero_(lm, 1)
    tr = LMTrainer(model=lm)
    state = tr.init_state()
    tokens = torch.randint(0, 1024, (2, 9, 64), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(2))
    reset_counts()
    state, met = tr.train_step(state, tokens)
    assert math.isfinite(met["train/loss"].item())
    assert math.isfinite(met["train/grad_norm"].item())
    assert not any(counts().values())
    del lm, tr, state
    small = AudioLM(**STABLE_LM_SMALL)
    small.reset_parameters(torch.Generator().manual_seed(3))
    nonzero_(small, 4)
    models = {"cpu": small, "cuda": copy.deepcopy(small).to(cuda_device)}
    g = torch.Generator().manual_seed(5)
    toks = [torch.randint(0, 32, (2, 4, 16), generator=g) for _ in range(2)]
    with full_f32():
        res = trainer_card_vs_cpu(
            "LMTrainer", {d: LMTrainer(model=m, lr=1e-3, clip_grad_norm=0.5)
                          for d, m in models.items()},
            lambda dev, n: ((toks[n].to(dev),), {}),
            {"b1": 0.9, "b2": 0.95, "weight_decay": 0.1}, 0.5, "cuda")
    assert res["param_over_bar"] <= 1 and res["grad_over_bar"] <= 1


@pytest.mark.cuda
def test_stable_train_vae_dac_step_on_card(cuda_device):
    """A VAE-GAN gen + disc step pair with DAC's discriminator (an MPD and
    an MRD) on the card against the CPU with the card's draws, TF32 off
    (chip_smoke.ae_card_vs_cpu): the gradients at the card's parameters,
    the losses 1e-4, the parameters at the train-step bars."""
    from chip_smoke import (STABLE_AE_DISCS, ae_card_vs_cpu, full_f32,
                            stable_ae_case)

    g = torch.Generator(device=cuda_device).manual_seed(6)
    with full_f32():
        res = ae_card_vs_cpu("VAE-GAN dac", device="cuda",
                             **stable_ae_case(STABLE_AE_DISCS["dac"], g))
    assert res["loss_rel"] <= 1e-4
    assert max(res["grad_over_bar"].values()) <= 1
