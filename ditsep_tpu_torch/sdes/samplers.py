"""Predictor-corrector sampling (port of ditsep_tpu/sdes/samplers.py:
pc_sample with ``schedule=None``). The N-step loop is a plain Python loop."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ditsep_tpu_torch.sdes.core import BaseSDE
from ditsep_tpu_torch.sdes.correctors import CorrectorRegistry
from ditsep_tpu_torch.sdes.predictors import PredictorRegistry

Tensor = torch.Tensor
ScoreFn = Callable[[Tensor, Tensor, Tensor], Tensor]


def pc_sample(
    sde: BaseSDE,
    score_fn: ScoreFn,
    y: Tensor,
    *,
    predictor: str = "reverse_diffusion",
    corrector: str = "ald2",
    N: Optional[int] = None,
    snr: float = 0.5,
    corrector_steps: int = 1,
    denoise: bool = True,
    eps: float = 3e-2,
    n_spkrs: int = 2,
    probability_flow: bool = False,
    schedule: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence] = None,
):
    """Predictor-corrector sampling over ``linspace(T, eps, N)``.

    ``noise`` optionally replaces every random draw with explicit
    standard-normal arrays, ``(prior_z (B, n_spkrs, ...), corrector_z
    (N, corrector_steps, B, n_spkrs, ...), predictor_z (N, B, n_spkrs,
    ...))``; otherwise the draws come from ``generator``, in the order
    prior, then for each step its corrector draws and its predictor draw.

    Returns ``(x, nfe)``; nfe counts real score evaluations ('none'
    steps cost nothing)."""
    if schedule is not None:
        raise NotImplementedError("scheduled pc_sample is not ported yet")
    if N is not None:
        sde = dataclasses.replace(sde, N=N)
    n = sde.N
    predictor_fn = PredictorRegistry.get_by_name(predictor)
    corrector_fn = CorrectorRegistry.get_by_name(corrector)

    batch = y.shape[0]
    shape = (batch, n_spkrs) + tuple(y.shape[2:])
    if noise is None:
        corr_z = pred_z = None
        x = sde.prior_sampling(generator, shape, y)
    else:
        prior_z, corr_z, pred_z = (
            torch.as_tensor(a, dtype=y.dtype, device=y.device) for a in noise)
        x = sde.prior_from_noise(prior_z, shape, y)

    # the grid in float64 on the host: no device round trip per step
    timesteps = torch.linspace(sde.T, eps, n, dtype=torch.float64).tolist()
    x_mean = x
    for i, t in enumerate(timesteps):
        t_vec = torch.full((batch,), t, dtype=y.dtype, device=y.device)
        x, _ = corrector_fn(
            sde, score_fn, x, t_vec, y, generator, snr=snr,
            n_steps=corrector_steps,
            noises=None if corr_z is None else corr_z[i])
        x, x_mean = predictor_fn(
            sde, score_fn, x, t_vec, y, generator,
            probability_flow=probability_flow,
            noise=None if pred_z is None else pred_z[i])

    nfe = n * (corrector_steps * (corrector != "none")
               + (predictor != "none"))
    return (x_mean if denoise else x), nfe
