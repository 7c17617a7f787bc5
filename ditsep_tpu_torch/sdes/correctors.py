"""Corrector steps for PC sampling (port of ditsep_tpu/sdes/correctors.py).
``noises`` (n_steps, *x.shape) replaces the draws from ``generator``."""
from __future__ import annotations

import torch

from ditsep_tpu_torch.sdes.core import BaseSDE, bcast_right
from ditsep_tpu_torch.sdes.predictors import _normal_like
from ditsep_tpu_torch.utils.registry import Registry

CorrectorRegistry = Registry("Corrector")


@CorrectorRegistry.register("langevin")
def langevin_corrector(sde: BaseSDE, score_fn, x, t, cond, generator=None,
                       snr: float = 0.1, n_steps: int = 1, noises=None):
    """Langevin MCMC, its step size matched to ``snr`` by the batch-mean
    norms of the noise and the score."""
    x_mean = x
    for i in range(n_steps):
        grad = score_fn(x, t, cond)
        noise = _normal_like(x, generator) if noises is None else noises[i]
        grad_norm = torch.linalg.vector_norm(
            grad.reshape(grad.shape[0], -1), dim=-1).mean()
        noise_norm = torch.linalg.vector_norm(
            noise.reshape(noise.shape[0], -1), dim=-1).mean()
        step_size = (snr * noise_norm / grad_norm) ** 2 * 2.0
        x_mean = x + step_size * grad
        x = x_mean + noise * torch.sqrt(step_size * 2.0)
    return x, x_mean


@CorrectorRegistry.register("ald")
def ald_corrector(sde: BaseSDE, score_fn, x, t, cond, generator=None,
                  snr: float = 0.1, n_steps: int = 1, noises=None):
    """Annealed Langevin dynamics, the step size from the scalar view of
    the std (``sde.std_scalar``)."""
    x_mean = x
    _, std = sde.marginal_prob(x, t, cond)
    s = bcast_right(sde.std_scalar(std), x.ndim)
    for i in range(n_steps):
        grad = score_fn(x, t, cond)
        noise = _normal_like(x, generator) if noises is None else noises[i]
        step_size = (snr * s) ** 2 * 2.0
        x_mean = x + step_size * grad
        x = x_mean + noise * torch.sqrt(step_size * 2.0)
    return x, x_mean


@CorrectorRegistry.register("ald2")
def ald2_corrector(sde: BaseSDE, score_fn, x, t, cond, generator=None,
                   snr: float = 0.1, n_steps: int = 1, noises=None):
    """Matrix annealed Langevin dynamics for Mix SDEs: the score is
    preconditioned by L L and the noise by 2*snr*L
    (ditsep_tpu/sdes/correctors.py:61-81)."""
    x_mean = x
    _, L = sde.marginal_prob(x, t, cond)
    for i in range(n_steps):
        grad = score_fn(x, t, cond)
        noise = _normal_like(x, generator) if noises is None else noises[i]
        step_size = 2.0 * snr ** 2
        grad = sde.mult_std(L, sde.mult_std(L, grad))
        x_mean = x + step_size * grad
        x = x_mean + 2.0 * snr * sde.mult_std(L, noise)
    return x, x_mean


@CorrectorRegistry.register("none")
def none_corrector(sde, score_fn, x, t, cond, generator=None, snr=0.0,
                   n_steps: int = 0, noises=None):
    return x, x
