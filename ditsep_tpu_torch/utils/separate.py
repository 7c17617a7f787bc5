"""Source ordering and batch normalization around separation and training
(port of ditsep_tpu.utils.separate).

The random helpers draw from an explicit ``torch.Generator`` on the
tensor's device, or take the raw draw the JAX function makes (``u``:
standard uniforms, ``sel``: integers) and apply the same transform to it,
so a test can hand both packages the same numbers."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ditsep_tpu_torch import parallel

Tensor = torch.Tensor


def _gather_sources(x: Tensor, idx: Tensor) -> Tensor:
    """Reorder axis 1 of x per batch entry by idx (B, n_src)."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def shuffle_sources(x: Tensor, generator: Optional[torch.Generator] = None,
                    u: Optional[Tensor] = None) -> Tensor:
    """Random per-batch-entry permutation along axis 1: the argsort of
    (B, n_src) standard uniforms ``u`` (drawn from ``generator`` when not
    given), as ditsep_tpu/utils/separate.py:23-30."""
    if x.ndim <= 1:
        return x
    if u is None:
        u = parallel.draw_rows(lambda s: torch.rand(
            s, generator=generator, device=x.device), x.shape[:2])
    return _gather_sources(x, torch.argsort(u.to(x.device), dim=1,
                                            stable=True))


def power_order_sources(x: Tensor) -> Tensor:
    """Order sources by increasing variance (population variance over all
    but the first two axes)."""
    if x.ndim <= 1:
        return x
    c = x.var(dim=tuple(range(2, x.ndim)), correction=0)
    return _gather_sources(x, torch.argsort(c, dim=1, stable=True))


def select_elem_at_random(x: Tensor, axis: int = -1,
                          generator: Optional[torch.Generator] = None,
                          sel: Optional[Tensor] = None) -> Tensor:
    """Pick one slice along ``axis`` per batch entry, keepdims: index
    ``sel`` (B,) integers in [0, x.shape[axis]), drawn when not given."""
    x = torch.movedim(x, axis, -1)
    if sel is None:
        sel = parallel.draw_rows(lambda s: torch.randint(
            0, x.shape[-1], s, generator=generator, device=x.device),
            (x.shape[0],))
    sel = sel.to(device=x.device, dtype=torch.int64)
    idx = sel.reshape((-1,) + (1,) * (x.ndim - 1)).expand(x.shape[:-1] + (1,))
    return torch.movedim(torch.gather(x, -1, idx), -1, axis)


def normalize_batch(
    batch: Tuple[Tensor, Optional[Tensor]],
    lengths: Optional[Tensor] = None,
) -> Tuple[Tuple[Tensor, Optional[Tensor]], Tensor, Tensor]:
    """Normalize by the mixture's mean and std over (C, T), per item.

    std is the unbiased (ddof=1) estimator, clipped below at 1e-5
    (ditsep_tpu/utils/separate.py:71-78). Per-item ``lengths`` (B,) take
    the statistics over each item's valid samples only (denominators
    max(n, 1) and max(n - 1, 1)) and zero the padded tail of the mixture
    and the target after normalizing, so that a padded batch equals the
    native-length one on the valid region (:79-92)."""
    mix, tgt = batch
    if lengths is None:
        mean = mix.mean(dim=(1, 2), keepdim=True)
        std = mix.std(dim=(1, 2), keepdim=True, correction=1).clamp(
            min=1e-5)
        mix = (mix - mean) / std
        if tgt is not None:
            tgt = (tgt - mean) / std
        return (mix, tgt), mean, std
    lengths = lengths.to(mix.device)[:, None, None]
    valid = torch.arange(mix.shape[-1], device=mix.device) < lengths
    n = (lengths * mix.shape[1]).to(mix.dtype)
    zero = torch.zeros((), dtype=mix.dtype, device=mix.device)
    mean = torch.where(valid, mix, zero).sum(
        dim=(1, 2), keepdim=True) / n.clamp(min=1.0)
    var = torch.where(valid, (mix - mean) ** 2, zero).sum(
        dim=(1, 2), keepdim=True) / (n - 1.0).clamp(min=1.0)
    std = var.sqrt().clamp(min=1e-5)
    mix = torch.where(valid, (mix - mean) / std, zero)
    if tgt is not None:
        tgt = torch.where(valid, (tgt - mean) / std, zero)
    return (mix, tgt), mean, std


def denormalize_batch(x: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    return x * std + mean


def pad_to_hop(x: Tensor, hop_length: int) -> Tensor:
    """Zero-pad the last axis up to a multiple of ``hop_length``; a length
    that is already a multiple is kept (the JAX package's deviation from
    the reference, which pads a full extra hop there)."""
    rem = x.shape[-1] % hop_length
    if rem == 0:
        return x
    return F.pad(x, (0, hop_length - rem))
