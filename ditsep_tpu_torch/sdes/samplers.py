"""Samplers (port of ditsep_tpu/sdes/samplers.py): predictor-corrector on
the plain or a scheduled grid, the second-order Adams-Bashforth
integrator, the probability-flow ODE (fixed-step, and adaptive on the host
through scipy) and the Schroedinger-bridge sampler. Each N-step loop is a
plain Python loop over a time grid built on the host.

Randomness is explicit: every sampler draws from ``generator``, or takes
``noise``, the standard-normal draws themselves (the layout is in each
docstring). Every sampler returns ``(x, nfe)``, nfe the score
evaluations it made.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ditsep_tpu_torch.sdes.core import BaseSDE, bcast_right
from ditsep_tpu_torch.sdes.correctors import CorrectorRegistry
from ditsep_tpu_torch.sdes.predictors import (
    PredictorRegistry, _normal_like,
)

Tensor = torch.Tensor
ScoreFn = Callable[[Tensor, Tensor, Tensor], Tensor]


def _linspace32(start: float, stop: float, num: int) -> np.ndarray:
    """``num`` points from start to stop in float32, by the JAX package's
    formula: start * (1 - i/div) + stop * i/div, the last point stop."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start32])
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    return np.append(start32 * (np.float32(1) - step) + stop32 * step,
                     stop32)


def _time_grid(schedule: Optional[str], T: float, eps: float,
               n: int) -> np.ndarray:
    """The float32 reverse-time grid: uniform (None, 'linear') or
    logarithmic ('log', 'revlog'). The JAX package builds it in float32
    too, so t and the steps between points carry float32's rounding, as
    there (up to an ulp: XLA folds the formula into constants under
    jit)."""
    if schedule in (None, "linear"):
        return _linspace32(T, eps, n)
    if schedule == "log":
        return np.power(np.float32(10),
                        _linspace32(math.log10(T), math.log10(eps), n))
    if schedule == "revlog":
        return np.power(np.float32(10),
                        _linspace32(math.log10(eps), math.log10(T), n)
                        )[::-1].copy()
    raise NotImplementedError(f"Schedule '{schedule}' does not exist")


def _tensors(arrays, like: Tensor) -> List[Optional[Tensor]]:
    return [None if a is None else torch.as_tensor(a, dtype=like.dtype,
                                                   device=like.device)
            for a in arrays]


def _state_shape(y: Tensor, n_spkrs: Optional[int]):
    if n_spkrs is None:
        return tuple(y.shape)
    return (y.shape[0], n_spkrs) + tuple(y.shape[2:])


def _prior(sde: BaseSDE, shape, y: Tensor, generator, prior_z):
    if prior_z is None:
        return sde.prior_sampling(generator, shape, y)
    return sde.prior_from_noise(prior_z, shape, y)


def _t_vec(t: float, y: Tensor) -> Tensor:
    return torch.full((y.shape[0],), float(t), dtype=y.dtype,
                      device=y.device)


def _denoised(sde: BaseSDE, score_fn: ScoreFn, x: Tensor, eps: float,
              y: Tensor) -> Tensor:
    """The mean of a reverse-diffusion step at t = eps (no noise)."""
    f, _ = sde.reverse_discretize(score_fn, x, _t_vec(eps, y), y)
    return x - f


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
    use_schedule_dt: bool = False,
    intermediate: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence] = None,
):
    """Predictor-corrector sampling.

    With ``schedule=None`` the steps are the N points of ``linspace(T,
    eps, N)`` (eps itself the last). With a schedule ('linear', 'log',
    'revlog') they are the first N of an N+1-point grid, so eps is never
    evaluated; the predictor's ``dt`` is the grid's spacing only with
    ``use_schedule_dt``, else 1/N (the reference drops the spacing).

    ``noise`` optionally replaces every random draw with explicit
    standard-normal arrays, ``(prior_z (B, n_spkrs, ...), corrector_z
    (N, corrector_steps, B, n_spkrs, ...), predictor_z (N, B, n_spkrs,
    ...))``; otherwise the draws come from ``generator``, in the order
    prior, then for each step its corrector draws and its predictor draw.

    Returns ``(x, nfe)``, or ``(x, nfe, (xs, x_means))`` with each step's
    state stacked when ``intermediate``; nfe counts real score
    evaluations ('none' steps cost nothing)."""
    if N is not None:
        sde = dataclasses.replace(sde, N=N)
    n = sde.N
    predictor_fn = PredictorRegistry.get_by_name(predictor)
    corrector_fn = CorrectorRegistry.get_by_name(corrector)

    shape = _state_shape(y, n_spkrs)
    prior_z, corr_z, pred_z = _tensors(noise or (None,) * 3, y)
    x = _prior(sde, shape, y, generator, prior_z)

    if schedule is None:
        timesteps, dts = _time_grid(None, sde.T, eps, n), None
    else:
        grid = _time_grid(schedule, sde.T, eps, n + 1)
        timesteps = grid[:-1]
        dts = np.abs(grid[:-1] - grid[1:]) if use_schedule_dt else None
    x_mean = x
    traj = []
    for i, t in enumerate(timesteps.tolist()):
        t_vec = _t_vec(t, y)
        x, _ = corrector_fn(
            sde, score_fn, x, t_vec, y, generator, snr=snr,
            n_steps=corrector_steps,
            noises=None if corr_z is None else corr_z[i])
        x, x_mean = predictor_fn(
            sde, score_fn, x, t_vec, y, generator,
            dt=None if dts is None else float(dts[i]),
            probability_flow=probability_flow,
            noise=None if pred_z is None else pred_z[i])
        if intermediate:
            traj.append((x, x_mean))

    nfe = n * (corrector_steps * (corrector != "none")
               + (predictor != "none"))
    x_result = x_mean if denoise else x
    if intermediate:
        return x_result, nfe, tuple(torch.stack(a) for a in zip(*traj))
    return x_result, nfe


def pc_generator_noise(generator: torch.Generator, shape, N: int,
                       corrector_steps: int = 1):
    """The draws ``pc_sample`` makes from ``generator`` for a state of
    ``shape``, in its order (the prior, then each step's corrector draws
    and its predictor draw), as its ``noise`` tuple on the generator's
    device. A run given this noise equals a run given a generator in the
    same state, so another device or package can be handed the same
    numbers."""
    draw = lambda: torch.randn(shape, generator=generator,  # noqa: E731
                               device=generator.device)
    prior, corr, pred = draw(), [], []
    for _ in range(N):
        corr.append(torch.stack([draw() for _ in range(corrector_steps)]))
        pred.append(draw())
    return prior, torch.stack(corr), torch.stack(pred)


def ab2_sample(
    sde: BaseSDE,
    score_fn: ScoreFn,
    y: Tensor,
    *,
    N: Optional[int] = None,
    eps: float = 3e-2,
    denoise: bool = True,
    n_spkrs: int = 2,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence] = None,
):
    """Second-order Adams-Bashforth integrator of the reverse drift: each
    step reuses the previous step's drift, x' = x - dt (3/2 f - 1/2
    f_prev) (the first step Euler), so a step costs one score evaluation.
    The N-point grid gives N - 1 steps at the segments' left ends, and the
    denoise step (a noise-free reverse-diffusion step at t = eps) the Nth
    evaluation. Deterministic (the probability flow) unless
    ``stochastic``, which adds the diffusion's Euler-Maruyama noise.

    ``noise``: ``(prior_z (B, n_spkrs, ...), step_z (N - 1, B, n_spkrs,
    ...) or None)``, step_z read only when ``stochastic``."""
    if N is not None:
        sde = dataclasses.replace(sde, N=N)
    n = sde.N
    shape = _state_shape(y, n_spkrs)
    prior_z, step_z = _tensors(noise or (None, None), y)
    x = _prior(sde, shape, y, generator, prior_z)
    n_steps = max(n - 1, 1)
    timesteps = _time_grid(None, sde.T, eps, n)[:n_steps]
    dt = (sde.T - eps) / n_steps
    f_prev = None
    for i, t in enumerate(timesteps.tolist()):
        f, g = sde.reverse_drift_diffusion(score_fn, x, _t_vec(t, y), y,
                                           probability_flow=not stochastic)
        f_ab = f if f_prev is None else 1.5 * f - 0.5 * f_prev
        x = x - dt * f_ab
        if stochastic:
            z = _normal_like(x, generator) if step_z is None else step_z[i]
            x = x + bcast_right(g, x.ndim) * math.sqrt(dt) * z
        f_prev = f
    nfe = n_steps
    if denoise:
        x = _denoised(sde, score_fn, x, eps, y)
        nfe += 1
    return x, nfe


ODE_EVALS = {"euler": 1, "heun": 2, "rk4": 4}


def ode_sample(
    sde: BaseSDE,
    score_fn: ScoreFn,
    y: Tensor,
    *,
    N: Optional[int] = None,
    eps: float = 3e-2,
    denoise: bool = True,
    n_spkrs: Optional[int] = 2,
    method: str = "rk4",
    generator: Optional[torch.Generator] = None,
    noise=None,
):
    """Probability-flow ODE with a fixed-step integrator ('euler', 'heun'
    or 'rk4') over the N + 1 points of linspace(T, eps), then the denoise
    step. ``n_spkrs`` None: ``y`` already has the state's shape.
    ``noise``: the prior's standard-normal draw."""
    if method not in ODE_EVALS:
        raise ValueError(f"unknown method {method}")
    if N is not None:
        sde = dataclasses.replace(sde, N=N)
    n = sde.N
    x = _prior(sde, _state_shape(y, n_spkrs), y, generator,
               _tensors([noise], y)[0])
    grid = _time_grid(None, sde.T, eps, n + 1)

    def drift(x, t):
        return sde.reverse_drift_diffusion(score_fn, x, _t_vec(t, y), y,
                                           probability_flow=True)[0]

    half, sixth = np.float32(0.5), np.float32(6.0)
    for i in range(n):
        t0, t1 = grid[i], grid[i + 1]
        h = t1 - t0  # negative (reverse time), in float32
        if method == "euler":
            x = x + float(h) * drift(x, t0)
        elif method == "heun":
            k1 = drift(x, t0)
            k2 = drift(x + float(h) * k1, t1)
            x = x + float(half * h) * (k1 + k2)
        else:
            tm = t0 + half * h
            k1 = drift(x, t0)
            k2 = drift(x + float(half * h) * k1, tm)
            k3 = drift(x + float(half * h) * k2, tm)
            k4 = drift(x + float(h) * k3, t1)
            x = x + float(h / sixth) * (k1 + 2 * k2 + 2 * k3 + k4)
    nfe = n * ODE_EVALS[method]
    if denoise:
        x = _denoised(sde, score_fn, x, eps, y)
        nfe += 1
    return x, nfe


def ode_sample_scipy(
    sde: BaseSDE,
    score_fn: ScoreFn,
    y: Tensor,
    *,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    method: str = "RK45",
    eps: float = 3e-2,
    denoise: bool = True,
    n_spkrs: Optional[int] = 2,
    generator: Optional[torch.Generator] = None,
    noise=None,
):
    """Adaptive solve of the probability-flow ODE from T to eps on the
    host (``scipy.integrate.solve_ivp``): every function evaluation copies
    the state to the device and the drift back. For parity with the
    reference's black-box sampler; ``ode_sample`` is the fast one.
    ``noise``: the prior's standard-normal draw."""
    from scipy import integrate

    x = _prior(sde, _state_shape(y, n_spkrs), y, generator,
               _tensors([noise], y)[0])
    shape, dtype = x.shape, x.dtype

    def ode_func(t, x_flat):
        x_arr = torch.as_tensor(x_flat.reshape(shape), dtype=dtype,
                                device=y.device)
        drift, _ = sde.reverse_drift_diffusion(
            score_fn, x_arr, _t_vec(t, y), y, probability_flow=True)
        return drift.cpu().numpy().reshape(-1)

    solution = integrate.solve_ivp(
        ode_func, (sde.T, eps), x.cpu().numpy().reshape(-1),
        rtol=rtol, atol=atol, method=method)
    nfe = solution.nfev
    x = torch.as_tensor(solution.y[:, -1].reshape(shape), dtype=dtype,
                        device=y.device)
    if denoise:
        x = _denoised(sde, score_fn, x, eps, y)
        nfe += 1
    return x, nfe


def sb_sample(
    sde,
    score_fn: ScoreFn,
    y: Tensor,
    *,
    eps: float = 1e-4,
    sampler_type: str = "ode",
    n_spkrs: int = 2,
    generator: Optional[torch.Generator] = None,
    noise=None,
):
    """First-order Schroedinger-bridge sampler, 'ode' or 'sde', over the
    N + 1 points of linspace(T, eps): each step weighs the model's
    estimate against the previous state and either the prior mean y
    ('ode') or noise ('sde', none at the last step). The state starts at
    y tiled over the sources and is kept in at least float32: at the first
    step sigma_bar_prev is sqrt(sde.eps) = 1e-4 and the weights divide by
    it. The 'ode' weights of the state and of y then nearly cancel (63 and
    -63 at N = 1, thousands at larger N), so rounding is scaled by as much.
    ``noise``: the 'sde' draws, (N, B, n_spkrs, ...), one a step.

    Returns ``(x, N)``."""
    n = sde.N
    out_dtype = y.dtype
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    xt0 = torch.cat([y] * n_spkrs, dim=1)
    steps = _tensors([noise], xt0)[0]
    grid = _time_grid(None, sde.T, eps, n + 1)
    sp, _, sbp, ap, _, _ = sde.sigmas_alphas(_t_vec(grid[0], y))
    xt = xt0
    for i, t in enumerate(grid[1:].tolist()):
        time = _t_vec(t, y)
        sigma_t, sigma_T, sigma_bart, alpha_t, alpha_T, _ = (
            sde.sigmas_alphas(time))
        estimate = score_fn(xt, time, y)
        b = lambda w: bcast_right(w, xt.ndim)  # noqa: E731
        if sampler_type == "sde":
            w_prev = alpha_t * sigma_t ** 2 / (ap * sp ** 2 + sde.eps)
            tmp = 1.0 - sigma_t ** 2 / (sp ** 2 + sde.eps)
            w_est = alpha_t * tmp
            xt = b(w_prev) * xt + b(w_est) * estimate
            if i < n - 1:  # the last step adds no noise
                z = _normal_like(xt, generator) if steps is None else steps[i]
                xt = xt + b(alpha_t * sigma_t * torch.sqrt(tmp)) * z
        else:
            w_prev = (alpha_t * sigma_t * sigma_bart
                      / (ap * sp * sbp + sde.eps))
            w_est = (alpha_t / (sigma_T ** 2 + sde.eps)
                     * (sigma_bart ** 2
                        - sbp * sigma_t * sigma_bart / (sp + sde.eps)))
            w_prior = (alpha_t / (alpha_T * sigma_T ** 2 + sde.eps)
                       * (sigma_t ** 2
                          - sp * sigma_t * sigma_bart / (sbp + sde.eps)))
            xt = b(w_prev) * xt + b(w_est) * estimate + b(w_prior) * xt0
        ap, sp, sbp = alpha_t, sigma_t, sigma_bart
    return xt.to(out_dtype), n
