"""Predictor steps for reverse-SDE sampling (port of
ditsep_tpu/sdes/predictors.py). Each returns ``(x, x_mean)``; ``noise``
replaces the draw from ``generator`` with an explicit standard-normal
tensor."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.sdes.core import BaseSDE, bcast_right
from ditsep_tpu_torch.utils.registry import Registry

PredictorRegistry = Registry("Predictor")


def _normal_like(x: torch.Tensor, generator: Optional[torch.Generator]):
    """Standard normals of x's shape (in a shard of a global batch, its
    rows of the global batch's draw)."""
    return parallel.draw_rows(lambda s: torch.randn(
        s, generator=generator, device=x.device, dtype=x.dtype), x.shape)


@PredictorRegistry.register("euler_maruyama")
def euler_maruyama_predictor(sde: BaseSDE, score_fn, x, t, cond,
                             generator=None, dt=None,
                             probability_flow: bool = False, noise=None):
    """Euler-Maruyama step of the reverse SDE over ``dt`` (1/N when
    None)."""
    if dt is None:
        dt = 1.0 / sde.N
    z = _normal_like(x, generator) if noise is None else noise
    f, g = sde.reverse_drift_diffusion(score_fn, x, t, cond,
                                       probability_flow=probability_flow)
    x_mean = x + f * -dt
    return x_mean + bcast_right(g, x.ndim) * math.sqrt(dt) * z, x_mean


@PredictorRegistry.register("reverse_diffusion")
def reverse_diffusion_predictor(sde: BaseSDE, score_fn, x, t, cond,
                                generator=None, dt=None,
                                probability_flow: bool = False, noise=None):
    """Reverse-diffusion discretization step."""
    f, G = sde.reverse_discretize(score_fn, x, t, cond, dt=dt,
                                  probability_flow=probability_flow)
    z = _normal_like(x, generator) if noise is None else noise
    x_mean = x - f
    return x_mean + bcast_right(G, x.ndim) * z, x_mean


@PredictorRegistry.register("none")
def none_predictor(sde, score_fn, x, t, cond, generator=None, dt=None,
                   probability_flow: bool = False, noise=None):
    return x, x
