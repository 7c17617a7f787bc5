"""Tests of the port's CUDA kernels: they need the card and skip without one.

This file imports no JAX, so that it also runs on a machine that has only
PyTorch. There, skip the repository's conftest (it configures JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import pytest
import torch

from ditsep_tpu_torch.models import NCSNpp
from ditsep_tpu_torch.ops import cuda_kernels, fir


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ulp_bf16(v: float) -> float:
    """One bf16 unit in the last place at magnitude ``v``."""
    return 2.0 ** (torch.tensor(v).abs().log2().floor().item() - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape,k,gain", [
    ((2, 8, 64, 144), (1, 3, 3, 1), 1.0),
    ((1, 6, 17, 9), (1, 2, 3, 4), 2.5),   # odd sizes, asymmetric kernel
    ((3, 5, 2, 2), (1, 3, 3, 1), 1.0),    # the smallest input
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
    tol = 1e-6 * peak if dtype == torch.float32 else _ulp_bf16(peak)
    assert (y.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_downsample_raises_not_falls_back(cuda_device):
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
