"""SI-SDR with permutation-invariant scoring (port of
ditsep_tpu/training/losses.py): the validation metric of training.

The permutation search is a brute-force max over the (n_src)! assignments
of the pairwise matrix, as in the JAX package (n_src is 2 or 3)."""
from __future__ import annotations

import itertools
from typing import Optional

import torch

Tensor = torch.Tensor


def si_sdr_pairwise(est: Tensor, ref: Tensor, *, zero_mean: bool = False,
                    clamp_db: Optional[float] = None,
                    eps: float = 1e-8) -> Tensor:
    """(..., n_est, T) estimates against (..., n_ref, T) references ->
    (..., n_est, n_ref) SI-SDR in dB. ``clamp_db`` soft-limits the value
    to +-clamp_db by regularizing the energy ratio."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        ref = ref - ref.mean(dim=-1, keepdim=True)
    dot = torch.einsum("...et,...rt->...er", est, ref)
    ref_pow = (ref ** 2).sum(dim=-1)[..., None, :]
    est_pow = (est ** 2).sum(dim=-1)[..., :, None]
    coh = dot ** 2 / torch.clamp(ref_pow * est_pow, min=eps)
    ratio = coh / torch.clamp(1.0 - coh, min=eps)
    if clamp_db is not None:
        tau = 10.0 ** (-clamp_db / 10.0)
        ratio = (coh + tau * (1.0 - coh)) / ((1.0 - coh) + tau * coh)
    return 10.0 * torch.log10(torch.clamp(ratio, min=eps))


def si_sdr_pit(est: Tensor, ref: Tensor, *, zero_mean: bool = False,
               clamp_db: Optional[float] = None) -> Tensor:
    """Permutation-optimal mean SI-SDR per batch entry: est, ref (B, n, T)
    -> (B,) dB (higher is better)."""
    mat = si_sdr_pairwise(est, ref, zero_mean=zero_mean, clamp_db=clamp_db)
    n = est.shape[-2]
    rows = torch.arange(n, device=est.device)
    scores = torch.stack(
        [mat[..., rows, torch.tensor(p, device=est.device)].mean(dim=-1)
         for p in itertools.permutations(range(n))], dim=-1)
    return scores.max(dim=-1).values


def si_sdr_loss(est: Tensor, ref: Tensor, *, zero_mean: bool = False,
                clamp_db: Optional[float] = None) -> Tensor:
    """The reference's SISDRLoss as logged for val/si_sdr (its sign flipped
    back, mean reduction): the batch mean of the positive PIT SI-SDR."""
    return si_sdr_pit(est, ref, zero_mean=zero_mean,
                      clamp_db=clamp_db).mean()
