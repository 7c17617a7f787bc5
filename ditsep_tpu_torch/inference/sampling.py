"""Diffusion samplers for v-objective and rectified-flow models (port of
ditsep_tpu/inference/sampling.py; reference: stable-audio-tools
inference/sampling.py:9-373).

Each sampler is a plain Python loop over a float32 time grid built on the
host by the JAX package's formulas (``jnp.linspace`` as
``sdes.samplers._linspace32``), its scalars computed in float32 and handed
to the device as Python floats: every step runs on the model's device with
no host round trip but the CFG gate's select. ``model(x, t, **extra)`` is
the denoiser, t a (B,) float32 tensor on x's device.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ditsep_tpu_torch.sdes.samplers import _linspace32

Tensor = torch.Tensor
ModelFn = Callable[..., Tensor]

_f32 = np.float32


def get_alphas_sigmas(t: Tensor) -> Tuple[Tensor, Tensor]:
    """The v-diffusion cosine schedule: (cos, sin) of t pi / 2."""
    return torch.cos(t * math.pi / 2), torch.sin(t * math.pi / 2)


def alpha_sigma_to_t(alpha: Tensor, sigma: Tensor) -> Tensor:
    return torch.atan2(sigma, alpha) / math.pi * 2


def distribution_shift_time(t, seq_len: int, base_shift: float = 0.5,
                            max_shift: float = 1.15, max_length: int = 4096,
                            min_length: int = 256, use_sine: bool = False):
    """The sequence-length-dependent timestep shift (reference:
    sampling.py:24-40), on a float32 array or tensor."""
    mu = -(base_shift + (max_shift - base_shift)
           * (seq_len - min_length) / (max_length - min_length))
    tt = torch.as_tensor(t, dtype=torch.float32)
    t_out = 1.0 - math.exp(mu) / (math.exp(mu) + (1.0 / (1.0 - tt) - 1.0))
    if use_sine:
        t_out = torch.sin(t_out * math.pi / 2)
    return t_out.numpy() if isinstance(t, np.ndarray) else t_out


def truncated_logistic_normal_rescaled(
        shape, left_trunc: float = 0.075, right_trunc: float = 1.0,
        generator: Optional[torch.Generator] = None,
        normal: Optional[Tensor] = None) -> Tensor:
    """Truncated logistic-normal timesteps for rectified-flow training,
    from the standard-normal draws ``normal`` or ``generator``."""
    if normal is None:
        normal = torch.randn(shape, generator=generator,
                             device=generator.device)
    ndtr = torch.special.ndtr
    cdf = ndtr(normal)
    lo = ndtr(torch.tensor(math.log(left_trunc / (1 - left_trunc)),
                           dtype=torch.float32))
    hi = (torch.tensor(1.0) if right_trunc >= 1.0 else ndtr(torch.tensor(
        math.log(right_trunc / (1 - right_trunc)), dtype=torch.float32)))
    trunc = lo.to(cdf) + (hi.to(cdf) - lo.to(cdf)) * cdf
    samples = torch.sigmoid(torch.special.ndtri(trunc))
    return (samples - left_trunc) / (right_trunc - left_trunc)


def _grid(sigma_max: float, steps: int, dist_shift: bool,
          seq_len: int) -> np.ndarray:
    t = _linspace32(sigma_max, 0.0, steps + 1)
    return distribution_shift_time(t, seq_len) if dist_shift else t


def _tvec(x: Tensor, ti) -> Tensor:
    return torch.full((x.shape[0],), float(ti), dtype=x.dtype,
                      device=x.device)


def sample(model: ModelFn, x: Tensor, steps: int, eta: float = 0.0,
           sigma_max: float = 1.0, dist_shift: bool = False,
           generator: Optional[torch.Generator] = None,
           noise: Optional[List[Tensor]] = None, **extra_args) -> Tensor:
    """DDIM-style v-diffusion sampler (reference: sampling.py:173-228).
    Returns the last step's denoised prediction ``pred``, as the JAX
    package does, not the state x. ``eta`` > 0 adds noise each step, from
    ``generator`` or the list ``noise`` (one draw of x's shape a step)."""
    t = _grid(sigma_max, steps, dist_shift, x.shape[-1])[:-1]
    t32 = torch.from_numpy(np.ascontiguousarray(t))
    alphas, sigmas = (a.numpy() for a in get_alphas_sigmas(t32))
    pred = x
    for i in range(steps):
        v = model(x, _tvec(x, t[i]), **extra_args)
        a, s = alphas[i], sigmas[i]
        pred = x * float(a) - v * float(s)
        if i == steps - 1:
            break
        eps = x * float(s) + v * float(a)
        a_next, s_next = alphas[i + 1], sigmas[i + 1]
        ddim_sigma = _f32(eta) * np.sqrt(max(
            s_next ** 2 / max(s ** 2, _f32(1e-20)), _f32(0))) * np.sqrt(
            max(_f32(1) - a ** 2 / max(a_next ** 2, _f32(1e-20)), _f32(0)))
        adjusted = np.sqrt(max(s_next ** 2 - ddim_sigma ** 2, _f32(0)))
        x = pred * float(a_next) + eps * float(adjusted)
        if eta:
            z = (noise[i] if noise is not None else torch.randn(
                x.shape, generator=generator, device=generator.device))
            x = x + z.to(x) * float(ddim_sigma)
    return pred


def sample_discrete_euler(model: ModelFn, x: Tensor, steps: int,
                          sigma_max: float = 1.0, dist_shift: bool = False,
                          **extra_args) -> Tensor:
    """Euler rectified-flow sampler (reference: sampling.py:73-102)."""
    t = _grid(sigma_max, steps, dist_shift, x.shape[-1])
    for i in range(steps):
        v = model(x, _tvec(x, t[i]), **extra_args)
        x = x + float(t[i + 1] - t[i]) * v
    return x


def sample_rk4(model: ModelFn, x: Tensor, steps: int, sigma_max: float = 1.0,
               dist_shift: bool = False, **extra_args) -> Tensor:
    """Fourth-order Runge-Kutta flow sampler (reference:
    sampling.py:104-136)."""
    t = _grid(sigma_max, steps, dist_shift, x.shape[-1])

    def f(x, ti):
        return model(x, _tvec(x, ti), **extra_args)

    for i in range(steps):
        t_curr, t_prev = t[i], t[i + 1]
        dt = t_prev - t_curr
        half = t_curr + dt / _f32(2)
        k1 = f(x, t_curr)
        k2 = f(x + float(dt) * k1 / 2, half)
        k3 = f(x + float(dt) * k2 / 2, half)
        k4 = f(x + float(dt) * k3, t_prev)
        x = x + float(dt) * (k1 + 2 * k2 + 2 * k3 + k4) / 6
    return x


def sample_flow_dpmpp(model: ModelFn, x: Tensor, steps: int,
                      sigma_max: float = 1.0, dist_shift: bool = False,
                      **extra_args) -> Tensor:
    """DPM-Solver++(2M) for rectified flow (reference:
    sampling.py:138-171)."""
    t = _grid(sigma_max, steps, dist_shift, x.shape[-1])
    eps = _f32(1e-10)

    def lam(s):  # log((1 - t) / t), float32
        return np.log(max(_f32(1) - s, eps)) - np.log(max(s, eps))

    old_denoised = x
    for i in range(steps):
        t_curr, t_next = t[i], t[i + 1]
        denoised = x - float(t_curr) * model(x, _tvec(x, t_curr),
                                             **extra_args)
        h = lam(t_next) - lam(t_curr)
        if i > 0:
            h_last = lam(t_curr) - lam(t[i - 1])
            r = h_last / (h if h != 0 else _f32(1))
            c = _f32(1) / (_f32(2) * r)
            denoised_d = (float(_f32(1) + c) * denoised
                          - float(c) * old_denoised)
        else:
            denoised_d = denoised
        if t_next <= eps:
            x = denoised_d
        else:
            sr = max(t_next, eps) / max(t_curr, eps)
            x = (float(sr) * x - float(np.expm1(-h) * (_f32(1) - t_next))
                 * denoised_d)
        old_denoised = denoised
    return x


def karras_sigmas(steps: int, sigma_min: float = 0.01,
                  sigma_max: float = 100.0, rho: float = 7.0) -> np.ndarray:
    """The Karras et al. (2022) sigma schedule, float32, a 0 appended."""
    ramp = _linspace32(0.0, 1.0, steps)
    min_inv = sigma_min ** (1 / rho)
    max_inv = sigma_max ** (1 / rho)
    sigmas = (_f32(max_inv) + ramp * _f32(min_inv - max_inv)) ** _f32(rho)
    return np.append(sigmas.astype(np.float32), _f32(0))


def sample_k(model: ModelFn, noise: Tensor, *, steps: int = 50,
             sigma_min: float = 0.5, sigma_max: float = 50.0,
             rho: float = 1.0, init_data: Optional[Tensor] = None,
             **extra_args) -> Tensor:
    """Karras-schedule Heun sampler for v-objective models, through
    k-diffusion's VDenoiser: denoised(x, sigma) = x c_skip + v(x c_in,
    t(sigma)) c_out, c_skip = 1/(sigma^2 + 1), c_out = -sigma c_in, c_in =
    1/sqrt(sigma^2 + 1), t = atan(sigma) 2/pi (the JAX package's
    deterministic second-order integrator)."""
    sigmas = karras_sigmas(steps, sigma_min, sigma_max, rho)
    x = noise * float(sigmas[0])
    if init_data is not None:
        x = init_data + x

    def denoised_of(x, sigma):
        c_in = _f32(1) / np.sqrt(sigma ** 2 + _f32(1))
        c_skip = _f32(1) / (sigma ** 2 + _f32(1))
        c_out = -sigma * c_in
        t = np.arctan(sigma) / _f32(math.pi) * _f32(2)
        v = model(x * float(c_in), _tvec(x, t), **extra_args)
        return x * float(c_skip) + v * float(c_out)

    for i in range(steps):
        s, s_next = sigmas[i], sigmas[i + 1]
        d = (x - denoised_of(x, s)) / float(max(s, _f32(1e-8)))
        x_e = x + d * float(s_next - s)
        if s_next > 0:
            d2 = (x_e - denoised_of(x_e, s_next)) / float(
                max(s_next, _f32(1e-8)))
            x = x + 0.5 * (d + d2) * float(s_next - s)
        else:
            x = x_e
    return x


def get_bmask(i, steps: int, mask: Tensor) -> Tensor:
    """Soft inpainting schedule: the binary mask hardens with the step."""
    strength = (i + 1) / steps
    return torch.where(mask <= strength, 1.0, 0.0).to(mask.dtype)


def sample_rf(model: ModelFn, noise: Tensor, *,
              init_data: Optional[Tensor] = None, steps: int = 100,
              sampler_type: str = "euler", sigma_max: float = 1.0,
              **extra_args) -> Tensor:
    """The rectified-flow entry point (reference: sampling.py:333-373):
    a variation starts from init * (1 - sigma_max) + noise * sigma_max."""
    sigma_max = min(sigma_max, 1.0)
    x = (noise if init_data is None
         else init_data * (1 - sigma_max) + noise * sigma_max)
    if sampler_type == "euler":
        return sample_discrete_euler(model, x, steps, sigma_max,
                                     **extra_args)
    if sampler_type == "rk4":
        return sample_rk4(model, x, steps, sigma_max, **extra_args)
    if sampler_type == "dpmpp":
        return sample_flow_dpmpp(model, x, steps, sigma_max, **extra_args)
    raise ValueError(f"unknown rf sampler {sampler_type}")
