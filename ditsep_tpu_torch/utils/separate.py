"""Batch normalization around separation (port of ditsep_tpu.utils.separate)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def normalize_batch(
    batch: Tuple[Tensor, Optional[Tensor]],
    lengths: Optional[Tensor] = None,
) -> Tuple[Tuple[Tensor, Optional[Tensor]], Tensor, Tensor]:
    """Normalize by the mixture's mean and std over (C, T), per item.

    std is the unbiased (ddof=1) estimator, clipped below at 1e-5
    (ditsep_tpu/utils/separate.py:71-78). Per-item ``lengths`` (masked
    statistics) are not ported yet and raise."""
    if lengths is not None:
        raise NotImplementedError(
            "normalize_batch(lengths=...) is not ported yet")
    mix, tgt = batch
    mean = mix.mean(dim=(1, 2), keepdim=True)
    std = mix.std(dim=(1, 2), keepdim=True, correction=1).clamp(min=1e-5)
    mix = (mix - mean) / std
    if tgt is not None:
        tgt = (tgt - mean) / std
    return (mix, tgt), mean, std


def denormalize_batch(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    return x * std + mean
