"""Corrector steps for PC sampling (port of ditsep_tpu/sdes/correctors.py).
``noises`` (n_steps, *x.shape) replaces the draws from ``generator``."""
from __future__ import annotations

from ditsep_tpu_torch.sdes.core import BaseSDE
from ditsep_tpu_torch.sdes.predictors import _normal_like
from ditsep_tpu_torch.utils.registry import Registry

CorrectorRegistry = Registry("Corrector")


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
