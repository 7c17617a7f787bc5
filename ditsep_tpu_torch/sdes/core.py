"""Forward SDEs with closed-form perturbation kernels (port of
ditsep_tpu/sdes/core.py: BaseSDE, MixSDE, MixStd, bcast_right, mix_mult,
mix_mult_inv).

The MixSDE std ``L = sqrt(ev1) A + sqrt(ev2) Pn`` is kept in eigen form
(:class:`MixStd`): A (the source-averaging projector) and Pn = I - A are
fixed, so applying L or its inverse is elementwise work, no solve.
Randomness is explicit: every draw takes a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ditsep_tpu_torch.utils.registry import Registry

SDERegistry = Registry("SDE")

Tensor = torch.Tensor

VARPROP_OVERSAMPLE = 8  # proposals per sample of MixSDE.sample_time_varprop


def bcast_right(a: Tensor, ndim: int) -> Tensor:
    """Append trailing singleton dims to ``a`` until it has ``ndim`` dims."""
    if a.ndim > ndim:
        raise ValueError(f"cannot broadcast {tuple(a.shape)} to ndim {ndim}")
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


class MixStd(NamedTuple):
    """``L = a * A + b * Pn``; a, b are (batch, 1, ...) tensors."""

    a: Tensor
    b: Tensor


Std = Union[Tensor, MixStd]


def _src_mean(x: Tensor) -> Tensor:
    """Mean over the source axis (axis 1), kept for broadcasting."""
    return x.mean(dim=1, keepdim=True)


def mix_mult(a: Tensor, b: Tensor, x: Tensor) -> Tensor:
    """(a A + b Pn) @ x by the projector identities."""
    m = _src_mean(x)
    return a * m + b * (x - m)


def mix_mult_inv(a: Tensor, b: Tensor, x: Tensor) -> Tensor:
    """(a A + b Pn)^{-1} @ x = (1/a) A x + (1/b) Pn x."""
    m = _src_mean(x)
    return m / a + (x - m) / b


@dataclasses.dataclass(frozen=True)
class BaseSDE:
    """Shared interface: subclasses define drift/diffusion and the
    closed-form perturbation kernel (marginal_prob)."""

    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def mult_std(self, std: Std, x: Tensor) -> Tensor:
        return bcast_right(std, x.ndim) * x

    def mult_std_inv(self, std: Std, x: Tensor) -> Tensor:
        return x / bcast_right(std, x.ndim)

    def std_scalar(self, std: Std) -> Tensor:
        return std

    def discretize(self, x: Tensor, t: Tensor, cond: Tensor, dt=None):
        """One forward Euler-Maruyama step's parts: (f, G); dt defaults
        to 1/N as in the reference."""
        if dt is None:
            dt = 1.0 / self.N
        drift, diffusion = self.drift_diffusion(x, t, cond)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse_discretize(self, score_fn, x, t, cond, dt=None,
                           probability_flow: bool = False):
        """Discretized reverse-SDE step parts (rev_f, rev_G)."""
        f, G = self.discretize(x, t, cond, dt=dt)
        score = score_fn(x, t, cond)
        G_b = bcast_right(G, x.ndim)
        rev_f = f - G_b ** 2 * score * (0.5 if probability_flow else 1.0)
        rev_G = torch.zeros_like(G) if probability_flow else G
        return rev_f, rev_G


@SDERegistry.register("mix")
@dataclasses.dataclass(frozen=True)
class MixSDE(BaseSDE):
    """Separation SDE ``dx = -lambda Pn x dt + g(t) dw`` in source space,
    g(t) = sigma_min (sigma_max/sigma_min)^t sqrt(2 log(sigma_max/sigma_min)).

    Closed forms:
      mean(t) = (A + exp(-lambda t) Pn) x0
      ev1     = s_min^2 (r^{2t} - 1)                              (A)
      ev2     = s_min^2 (r^{2t} - e^{-2 lambda t}) / (1 + lambda/log r) (Pn)
      std     = sqrt(ev1) A + sqrt(ev2) Pn
    """

    ndim: int = 2
    d_lambda: float = 2.0
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 30

    @property
    def logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    @property
    def ratiosig(self) -> float:
        return self.sigma_max / self.sigma_min

    def drift_diffusion(self, x: Tensor, t: Tensor, cond=None):
        drift = -self.d_lambda * (x - _src_mean(x))  # -lambda Pn x
        sigma = self.sigma_min * self.ratiosig ** t
        return drift, sigma * math.sqrt(2.0 * self.logsig)

    def mean(self, x0: Tensor, t: Tensor) -> Tensor:
        decay = bcast_right(torch.exp(-t * self.d_lambda), x0.ndim)
        m = _src_mean(x0)
        return m + decay * (x0 - m)

    def cov_eigval(self, t: Tensor) -> Tuple[Tensor, Tensor]:
        mult = self.sigma_min ** 2
        s_ratio_power = self.ratiosig ** (2.0 * t)
        ev1 = mult * (s_ratio_power - 1.0)
        exponential = torch.exp(-2.0 * self.d_lambda * t)
        denom = 1.0 + self.d_lambda / self.logsig
        ev2 = mult * (s_ratio_power - exponential) / denom
        return ev1, ev2

    def var(self, t: Tensor) -> Tensor:
        """Per-component marginal variance: ev1/n + ev2 (n-1)/n."""
        ev1, ev2 = self.cov_eigval(t)
        n = self.ndim
        return ev1 / n + ev2 * (n - 1) / n

    def std(self, t: Tensor, state_ndim: int = 3) -> MixStd:
        ev1, ev2 = self.cov_eigval(t)
        return MixStd(bcast_right(torch.sqrt(ev1), state_ndim),
                      bcast_right(torch.sqrt(ev2), state_ndim))

    def marginal_prob(self, x0: Tensor, t: Tensor, cond=None):
        return self.mean(x0, t), self.std(t, x0.ndim)

    def mult_std(self, std: MixStd, x: Tensor) -> Tensor:
        return mix_mult(std.a, std.b, x)

    def mult_std_inv(self, std: MixStd, x: Tensor) -> Tensor:
        return mix_mult_inv(std.a, std.b, x)

    def std_scalar(self, std: MixStd) -> Tensor:
        n = self.ndim
        return torch.sqrt(std.a ** 2 / n + std.b ** 2 * (n - 1) / n)

    def prior_sampling(self, generator: Optional[torch.Generator],
                       shape: Tuple[int, ...], mix: Tensor) -> Tensor:
        """x_T ~ N(broadcast(mix / n), Sigma(T)); ``mix`` is (B, 1, T)."""
        z = torch.randn(shape, generator=generator, device=mix.device,
                        dtype=mix.dtype)
        return self.prior_from_noise(z, shape, mix)

    def prior_from_noise(self, z: Tensor, shape: Tuple[int, ...],
                         mix: Tensor) -> Tensor:
        """Prior sample from an explicit standard-normal draw ``z``."""
        t = torch.full((mix.shape[0],), self.T, dtype=mix.dtype,
                       device=mix.device)
        mean = (mix / self.ndim).expand(shape)
        return mean + self.mult_std(self.std(t, len(shape)), z)

    def sample_time_varprop(self, generator: Optional[torch.Generator],
                            n: int, t_eps: float = 0.0, *, device=None,
                            u: Optional[Tensor] = None,
                            accept_u: Optional[Tensor] = None) -> Tensor:
        """t in [t_eps, T] with density proportional to the noise std, by
        vectorized rejection (ditsep_tpu/sdes/core.py:252-270): m =
        VARPROP_OVERSAMPLE * n uniform proposals ``u``, accepted where
        ``accept_u`` * std(T) < std(t), accepted first in their order, then
        the rejected ones. ``u`` and ``accept_u`` are (m,) standard
        uniforms, drawn from ``generator`` when not given."""
        m = VARPROP_OVERSAMPLE * n
        if u is None:
            u = torch.rand(m, generator=generator, device=device)
        if accept_u is None:
            accept_u = torch.rand(m, generator=generator, device=u.device)
        t = torch.clamp(u * (self.T - t_eps) + t_eps, min=t_eps)
        l_max = torch.sqrt(self.var(torch.full((1,), self.T,
                                               device=u.device)))[0]
        acc = accept_u.to(u.device) * l_max < torch.sqrt(self.var(t))
        order = torch.argsort((~acc).to(torch.uint8), stable=True)
        return t[order[:n]]
