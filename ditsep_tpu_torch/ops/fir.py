"""FIR-based up/down resampling on NCHW tensors (port of ditsep_tpu/ops/fir.py).

``downsample_2d`` dispatches on the tensor: a CPU tensor goes to the plain
PyTorch version (differentiated by autograd), a CUDA tensor to the
hand-written ``fir_down2d`` kernel, which raises on anything it does not
take; where a gradient is wanted the CUDA call goes through
``FirDown2dFunction``, whose backward is the kernel ``fir_up2d``.
``upsample_2d`` is a stock
PyTorch depthwise convolution on every device, as the JAX package computes
it outside any Pallas kernel too.
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
