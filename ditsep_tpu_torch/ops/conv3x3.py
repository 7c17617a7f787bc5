"""The bordered 3x3 conv of the conv probe (scripts/pallas_conv_probe.py).

Both functions take the JAX layout as it is: contiguous NHWC x
(B, H+2, W+2*padw, C) with zero borders and w9 (9, C, C2), tap ky*3+kx,
and return (B, H+2, W+2*padw, C2) with exact-zero borders, so the layout
is closed under the op. A CPU tensor goes to the plain PyTorch version; a
CUDA tensor to the hand-written kernel, which raises on what it does not
take (bf16 only, C and C2 multiples of 16).
"""
from __future__ import annotations

import torch

from ditsep_tpu_torch.ops.cuda_kernels import (
    conv3x3_9tap, conv3x3_async_halo, conv3x3_bordered_plain,
)

Tensor = torch.Tensor


def _dispatch(kernel, x: Tensor, w9: Tensor, padw: int) -> Tensor:
    if x.device.type == "cpu":
        return conv3x3_bordered_plain(x, w9, padw)
    if x.device.type != "cuda":
        raise ValueError(f"{kernel.entry} runs on the CPU or CUDA, got "
                         f"{x.device}")
    return kernel(x, w9, padw)


def conv3x3_bordered(x: Tensor, w9: Tensor) -> Tensor:
    """The conv on a 1-pixel border (``conv3x3_pallas``'s contract)."""
    return _dispatch(conv3x3_9tap, x, w9, 1)


def conv3x3_bordered_async(x: Tensor, w9: Tensor, padw: int = 4) -> Tensor:
    """The conv on ``padw`` border columns a side (``conv3x3_pallas_dma``'s
    contract), through the kernel that prefetches its halo windows."""
    return _dispatch(conv3x3_async_halo, x, w9, padw)
