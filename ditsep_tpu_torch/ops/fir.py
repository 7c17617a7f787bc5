"""FIR-based up/down resampling on NCHW tensors (port of ditsep_tpu/ops/fir.py).

``downsample_2d`` dispatches on the tensor: a CPU tensor goes to the plain
PyTorch version (differentiated by autograd), a CUDA tensor to the
hand-written ``fir_down2d`` kernel, which raises on anything it does not
take; where a gradient is wanted the CUDA call goes through
``FirDown2dFunction``, whose backward is the kernel ``fir_up2d``.
``upsample_2d`` is a stock
PyTorch depthwise convolution on every device, as the JAX package computes
it outside any Pallas kernel too, and so are the conv-fused resamplers
``upsample_conv_2d`` and ``conv_downsample_2d``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ditsep_tpu_torch.ops.cuda_kernels import (
    downsample_2d_cuda, downsample_2d_plain,
)
from ditsep_tpu_torch.ops.upfirdn2d import setup_fir_kernel, upfirdn2d

Tensor = torch.Tensor


def naive_upsample_2d(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upsampling."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def naive_downsample_2d(x: Tensor, factor: int = 2) -> Tensor:
    """Box-mean downsampling."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // factor, factor, w // factor, factor)
    return x.mean(dim=(3, 5))


def upsample_2d(x: Tensor, k: Optional[Sequence[float]] = None,
                factor: int = 2, gain: float = 1.0) -> Tensor:
    """FIR upsampling by ``factor`` (pad rule of ditsep_tpu/ops/fir.py:40-42)."""
    if k is None:
        k = [1.0] * factor
    kern = setup_fir_kernel(k, gain * factor ** 2)
    p = kern.shape[0] - factor
    return upfirdn2d(x, kern, up=factor,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: Tensor, k: Optional[Sequence[float]] = None,
                  factor: int = 2, gain: float = 1.0) -> Tensor:
    """FIR downsampling by ``factor``: upfirdn2d(down=factor) with pad
    ((p+1)//2, p//2), p = len(k) - factor (ditsep_tpu/ops/fir.py:45-52).
    On CUDA with a gradient wanted, its backward is ``fir_up2d``."""
    if x.device.type == "cpu":
        return downsample_2d_plain(x, k, factor=factor, gain=gain)
    return downsample_2d_cuda(x, k, factor=factor, gain=gain)


def upsample_conv_2d(x: Tensor, w: Tensor,
                     k: Optional[Sequence[float]] = None, factor: int = 2,
                     gain: float = 1.0) -> Tensor:
    """A stride-``factor`` transposed conv then FIR filtering
    (ditsep_tpu/ops/fir.py:55-91). x (N, Cin, H, W), w (Cout, Cin, kh, kw)
    OIHW -> (N, Cout, H*factor, W*factor). The JAX op's input-dilated conv
    with the flipped HWIO kernel is ``F.conv_transpose2d`` with the
    kernel as it is, in (Cin, Cout, kh, kw)."""
    kh, kw = w.shape[-2:]
    assert kh == kw
    if k is None:
        k = [1.0] * factor
    kern = setup_fir_kernel(k, gain * factor ** 2)
    p = (kern.shape[0] - factor) - (kh - 1)
    x = torch.nn.functional.conv_transpose2d(x, w.transpose(0, 1),
                                             stride=factor)
    return upfirdn2d(x, kern, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: Tensor, w: Tensor,
                       k: Optional[Sequence[float]] = None, factor: int = 2,
                       gain: float = 1.0) -> Tensor:
    """FIR filtering then a stride-``factor`` conv (ditsep_tpu/ops/
    fir.py:94-120). x (N, Cin, H, W), w (Cout, Cin, kh, kw) -> (N, Cout,
    H//factor, W//factor). Plain PyTorch on every device: the filter runs
    at full resolution (no decimation), which ``fir_down2d`` does not
    compute, as the JAX op runs outside any Pallas kernel."""
    kh, kw = w.shape[-2:]
    assert kh == kw
    if k is None:
        k = [1.0] * factor
    kern = setup_fir_kernel(k, gain)
    p = (kern.shape[0] - factor) + (kh - 1)
    x = upfirdn2d(x, kern, pad=((p + 1) // 2, p // 2))
    return torch.nn.functional.conv2d(x, w, stride=factor)
