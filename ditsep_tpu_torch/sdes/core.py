"""Forward SDEs with closed-form perturbation kernels (port of
ditsep_tpu/sdes/core.py): the matrix SDEs MixSDE and PriorMixSDE, the
scalar OUVESDE and the Schroedinger-bridge SBVESDE.

The MixSDE std ``L = sqrt(ev1) A + sqrt(ev2) Pn`` is kept in eigen form
(:class:`MixStd`): A (the source-averaging projector) and Pn = I - A are
fixed, so applying L or its inverse is elementwise work, no solve.
PriorMixSDE scales it per sample and time by a sliding RMS of the mixture
(:class:`PriorMixStd`). Randomness is explicit: every draw takes a
``torch.Generator``, and ``prior_from_noise`` takes the draw itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ditsep_tpu_torch import parallel
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


class PriorMixStd(NamedTuple):
    """``L = (a * A + b * Pn) @ diag(sig)``; sig is the (batch, 1 or n,
    T) signal-adaptive scale."""

    a: Tensor
    b: Tensor
    sig: Tensor


Std = Union[Tensor, MixStd, PriorMixStd]


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
        return drift * dt, diffusion * math.sqrt(float(dt))

    def reverse_discretize(self, score_fn, x, t, cond, dt=None,
                           probability_flow: bool = False):
        """Discretized reverse-SDE step parts (rev_f, rev_G)."""
        f, G = self.discretize(x, t, cond, dt=dt)
        score = score_fn(x, t, cond)
        G_b = bcast_right(G, x.ndim)
        rev_f = f - G_b ** 2 * score * (0.5 if probability_flow else 1.0)
        rev_G = torch.zeros_like(G) if probability_flow else G
        return rev_f, rev_G

    def reverse_drift_diffusion(self, score_fn, x, t, cond,
                                probability_flow: bool = False):
        """Continuous reverse-time drift and diffusion."""
        drift, diffusion = self.drift_diffusion(x, t, cond)
        score = score_fn(x, t, cond)
        d_b = bcast_right(diffusion, x.ndim)
        total = drift - d_b ** 2 * score * (0.5 if probability_flow else 1.0)
        return total, (torch.zeros_like(diffusion) if probability_flow
                       else diffusion)


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
        z = parallel.draw_rows(lambda s: torch.randn(
            s, generator=generator, device=mix.device, dtype=mix.dtype),
            shape)
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


@SDERegistry.register("priormix")
@dataclasses.dataclass(frozen=True)
class PriorMixSDE(MixSDE):
    """MixSDE with signal-adaptive noise: the std is scaled per sample and
    time by a sliding RMS of the mixture (``sigma_mix``)."""

    avg_len: int = 510

    def sigma_mix(self, mix: Tensor) -> Tensor:
        """0.5 * sqrt(clamp(mean of mix^2 over a window of avg_len, 1e-4)),
        the window centred with avg_len // 2 zeros on each side counted
        (avg_pool1d with count_include_pad); for an even avg_len the
        extra last frame is dropped. The JAX package takes the same means
        as differences of a running sum; the pooling sums each window
        directly and loses no digits to cancellation."""
        k = self.avg_len
        p2 = (mix ** 2).reshape(-1, 1, mix.shape[-1])
        win = F.avg_pool1d(p2, k, stride=1, padding=k // 2,
                           count_include_pad=True)[..., :mix.shape[-1]]
        return 0.5 * torch.sqrt(torch.clamp(win.reshape(mix.shape),
                                            min=1e-4))

    def std(self, t: Tensor, mix: Tensor,  # type: ignore[override]
            state_ndim: int = 3) -> PriorMixStd:
        ev1, ev2 = self.cov_eigval(t)
        return PriorMixStd(bcast_right(torch.sqrt(ev1), state_ndim),
                           bcast_right(torch.sqrt(ev2), state_ndim),
                           self.sigma_mix(mix))

    def drift_diffusion(self, x: Tensor, t: Tensor, mix: Tensor):
        drift = -self.d_lambda * (x - _src_mean(x))
        sig = self.sigma_mix(mix).expand(x.shape[0], self.ndim, x.shape[-1])
        sigma = self.sigma_min * self.ratiosig ** t
        return drift, (bcast_right(sigma, sig.ndim)
                       * math.sqrt(2 * self.logsig) * sig)

    def marginal_prob(self, x0: Tensor, t: Tensor, mix: Tensor):
        return self.mean(x0, t), self.std(t, mix, x0.ndim)

    def mult_std(self, std: PriorMixStd, x: Tensor) -> Tensor:
        # L = (a A + b Pn) @ diag(sig): scale first, then mix
        return mix_mult(std.a, std.b, std.sig * x)

    def mult_std_inv(self, std: PriorMixStd, x: Tensor) -> Tensor:
        return mix_mult_inv(std.a, std.b, x) / std.sig

    def std_scalar(self, std: PriorMixStd) -> Tensor:
        n = self.ndim
        return torch.sqrt(std.a ** 2 / n + std.b ** 2 * (n - 1) / n) * std.sig

    def prior_from_noise(self, z: Tensor, shape: Tuple[int, ...],
                         mix: Tensor) -> Tensor:
        """As the reference: a mix that already has ndim channels is the
        prior mean per source unscaled, a (B, 1, T) mix is divided by
        ndim."""
        t = torch.full((mix.shape[0],), self.T, dtype=mix.dtype,
                       device=mix.device)
        std = self.std(t, mix, len(shape))
        mean = mix if mix.shape[1] == self.ndim else (mix / self.ndim
                                                      ).expand(shape)
        return mean + self.mult_std(std, z)


@SDERegistry.register("ouve")
@dataclasses.dataclass(frozen=True)
class OUVESDE(BaseSDE):
    """Ornstein-Uhlenbeck variance-exploding SDE
    ``dx = theta (y - x) dt + g(t) dw``:

      mean(t) = e^{-theta t} x0 + (1 - e^{-theta t}) y
      std(t)  = sqrt(s_min^2 e^{-2 theta t} (e^{2(theta+logsig)t} - 1)
                     * logsig / (theta + logsig))
    """

    theta: float = 1.5
    sigma_min: float = 0.05
    sigma_max: float = 0.5
    N: int = 1000

    @property
    def logsig(self) -> float:
        return math.log(self.sigma_max / self.sigma_min)

    def drift_diffusion(self, x: Tensor, t: Tensor, y: Tensor):
        sigma = self.sigma_min * (self.sigma_max / self.sigma_min) ** t
        return self.theta * (y - x), sigma * math.sqrt(2.0 * self.logsig)

    def mean(self, x0: Tensor, t: Tensor, y: Tensor) -> Tensor:
        e = bcast_right(torch.exp(-self.theta * t), x0.ndim)
        return e * x0 + (1.0 - e) * y

    def std(self, t: Tensor) -> Tensor:
        s, th, ls = self.sigma_min, self.theta, self.logsig
        return torch.sqrt(
            (s ** 2 * torch.exp(-2 * th * t)
             * (torch.exp(2 * (th + ls) * t) - 1) * ls) / (th + ls))

    def var(self, t: Tensor) -> Tensor:
        return self.std(t) ** 2

    def marginal_prob(self, x0: Tensor, t: Tensor, y: Tensor):
        return self.mean(x0, t, y), self.std(t)

    def prior_sampling(self, generator: Optional[torch.Generator],
                       shape: Tuple[int, ...], y: Tensor) -> Tensor:
        z = parallel.draw_rows(lambda s: torch.randn(
            s, generator=generator, device=y.device, dtype=y.dtype), shape)
        return self.prior_from_noise(z, shape, y)

    def prior_from_noise(self, z: Tensor, shape: Tuple[int, ...],
                         y: Tensor) -> Tensor:
        std = self.std(torch.ones((y.shape[0],), dtype=y.dtype,
                                  device=y.device))
        return y.expand(shape) + z * bcast_right(std, len(shape))


@SDERegistry.register("sbve")
@dataclasses.dataclass(frozen=True)
class SBVESDE(BaseSDE):
    """Schroedinger-bridge VE SDE (Jukic et al. 2024): sigma_t^2 = c
    (k^{2t} - 1) / (2 ln k), alpha = 1; the prior is x_T = y exactly."""

    k: float = 2.6
    c: float = 0.4
    N: int = 50
    eps: float = 1e-8
    sampler_type: str = "ode"

    def drift_diffusion(self, x: Tensor, t: Tensor, y=None):
        return torch.zeros_like(x), math.sqrt(self.c) * self.k ** t

    def sigmas_alphas(self, t: Tensor):
        """(sigma_t, sigma_T, sigma_bart, alpha_t, alpha_T, alpha_bart).
        sigma_T is computed by the expression of sigma_t, so that sigma_T^2
        - sigma_t^2 is exactly 0 at t = T and sigma_bart = sqrt(eps)."""
        log_k = math.log(self.k)

        def sig(tt):
            return torch.sqrt(self.c * (self.k ** (2 * tt) - 1.0)
                              / (2 * log_k))

        sigma_t = sig(t)
        sigma_T = sig(torch.full_like(t, self.T))
        alpha_t = torch.ones_like(t)
        alpha_T = torch.ones_like(t)
        alpha_bart = alpha_t / (alpha_T + self.eps)
        sigma_bart = torch.sqrt(sigma_T ** 2 - sigma_t ** 2 + self.eps)
        return sigma_t, sigma_T, sigma_bart, alpha_t, alpha_T, alpha_bart

    def mean(self, x0: Tensor, t: Tensor, y: Tensor) -> Tensor:
        sigma_t, sigma_T, sigma_bart, alpha_t, _, alpha_bart = (
            self.sigmas_alphas(t))
        w_xt = alpha_t * sigma_bart ** 2 / (sigma_T ** 2 + self.eps)
        w_yt = alpha_bart * sigma_t ** 2 / (sigma_T ** 2 + self.eps)
        return (bcast_right(w_xt, x0.ndim) * x0
                + bcast_right(w_yt, x0.ndim) * y)

    def std(self, t: Tensor) -> Tensor:
        sigma_t, sigma_T, sigma_bart, alpha_t, *_ = self.sigmas_alphas(t)
        return alpha_t * sigma_bart * sigma_t / (sigma_T + self.eps)

    def marginal_prob(self, x0: Tensor, t: Tensor, y: Tensor):
        return self.mean(x0, t, y), self.std(t)

    def prior_sampling(self, generator: Optional[torch.Generator],
                       shape: Tuple[int, ...], y: Tensor) -> Tensor:
        return y.expand(shape)

    def prior_from_noise(self, z: Tensor, shape: Tuple[int, ...],
                         y: Tensor) -> Tensor:
        return y.expand(shape)
