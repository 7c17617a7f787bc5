"""upfirdn2d: upsample -> FIR filter -> downsample on NCHW feature maps.

Port of ditsep_tpu/ops/upfirdn2d.py in plain PyTorch. The rules carried
over from the JAX op:

* zero-stuffing puts ``up-1`` zeros AFTER every input sample (size
  ``in*up``), as the reference CUDA op does; the JAX op reaches the same
  result with lhs-dilation plus ``up-1`` extra high padding;
* pads may be negative (they crop);
* the filter is applied flipped, i.e. a true convolution;
* the kernel is cast to ``x.dtype``.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def setup_fir_kernel(k: Union[Sequence[float], np.ndarray],
                     gain: float = 1.0) -> np.ndarray:
    """Normalize a 1-D (separable) or 2-D FIR kernel to unit DC gain, times
    ``gain``. Returns a float32 (kh, kw) numpy array."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"FIR kernel must be 1-D or square 2-D, got {k.shape}")
    return k * gain


def pad_or_crop(x: Tensor, dim: int, lo: int, hi: int) -> Tensor:
    """Zero-pad (positive) or crop (negative) axis ``dim`` at both ends."""
    if lo > 0 or hi > 0:
        cfg = [0, 0] * (x.ndim - dim)
        # F.pad lists pads from the last axis backwards
        cfg[2 * (x.ndim - 1 - dim)] = max(lo, 0)
        cfg[2 * (x.ndim - 1 - dim) + 1] = max(hi, 0)
        x = F.pad(x, cfg)
    if lo < 0:
        x = x.narrow(dim, -lo, x.shape[dim] + lo)
    if hi < 0:
        x = x.narrow(dim, 0, x.shape[dim] + hi)
    return x


def upfirdn2d(
    x: Tensor,
    kernel,
    up: Union[int, Tuple[int, int]] = 1,
    down: Union[int, Tuple[int, int]] = 1,
    pad: Tuple[int, int] = (0, 0),
) -> Tensor:
    """Apply upfirdn to an (N, C, H, W) tensor.

    ``kernel`` is a (kh, kw) array or tensor; ``pad = (pad0, pad1)`` applies
    to both spatial axes after upsampling and may be negative. Output size
    along H is ``(H*up_y + pad0 + pad1 - kh) // down_y + 1``."""
    up_y, up_x = (up, up) if isinstance(up, int) else up
    down_y, down_x = (down, down) if isinstance(down, int) else down
    pad0, pad1 = pad
    n, c, h, w = x.shape

    kernel = torch.as_tensor(np.asarray(kernel), dtype=x.dtype,
                             device=x.device)
    kh, kw = kernel.shape
    if up_y > 1 or up_x > 1:
        z = x.new_zeros(n, c, h * up_y, w * up_x)
        z[:, :, ::up_y, ::up_x] = x
        x = z
    x = pad_or_crop(x, 2, pad0, pad1)
    x = pad_or_crop(x, 3, pad0, pad1)
    wk = torch.flip(kernel, (0, 1)).reshape(1, 1, kh, kw).expand(c, 1, kh, kw)
    return F.conv2d(x, wk, stride=(down_y, down_x), groups=c)
