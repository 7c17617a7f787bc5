"""Learning-rate schedules and optimizers of the stable-audio training
wrappers, the LDM decoder finetune and the VAE-GAN (port of
ditsep_tpu/training/schedules.py and the optax chains of
ditsep_tpu/training/{ldm,autoencoder,diffusion,lm}.py).

A schedule is a function of optax's update count n (0 on the first
update), evaluated in float32 step by step as optax evaluates it. Its
transcendental step (a power, a cosine) is computed in float64 and
rounded once: XLA's float32 ``pow`` and ``cos`` are approximations of
their own, within an ulp of that rounding, so no float32 library call
reproduces them bit for bit.

An optimizer is a ``ScheduledOptimizer``: a ``torch.optim`` optimizer on
a list of float32 parameters, updated in place, under a ``LambdaLR`` that
sets each update's rate to the schedule at the count of updates before
it, after an optional global-norm clip (optax's ``clip_by_global_norm``
chained first). ``create_optimizer_from_config`` reads the reference's
optimizer schema into an ``OptimizerSpec``, which builds one for given
parameters, as an optax transform is built before the parameters it
updates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ditsep_tpu_torch.training.diffsep import clip_by_global_norm_

Tensor = torch.Tensor
Schedule = Callable[[int], float]
f32 = np.float32


def inverse_lr_schedule(base_lr: float, inv_gamma: float = 200000.0,
                        power: float = 0.5, warmup: float = 0.999
                        ) -> Schedule:
    """k-diffusion's InverseLR, exponential warmup then inverse-power
    decay, at optax's update count n:

        lr(n) = base_lr * (1 - warmup^(n+1)) * (1 + n/inv_gamma)^-power

    evaluated in float32, as optax evaluates it (1 - 0.999 is 1.3e-5 off
    in float32, so a float64 schedule would part from JAX's there)."""
    base, gamma, wu, pw = f32(base_lr), f32(inv_gamma), f32(warmup), f32(power)

    def schedule(n: int) -> float:
        s = f32(n)
        w = f32(1.0) - wu ** (s + f32(1.0)) if warmup > 0 else f32(1.0)
        return float(base * w * (f32(1.0) + s / gamma) ** -pw)

    return schedule


def _pow32(x, y) -> np.float32:
    """float32 x ** y, rounded once from float64."""
    return f32(np.float64(x) ** np.float64(y))


def exponential_schedule(init: float, gamma: float) -> Schedule:
    """optax.exponential_decay(init, transition_steps=1, decay_rate=gamma):
    init at n = 0, init * gamma^n after."""
    def schedule(n: int) -> float:
        if n <= 0:
            return float(f32(init))
        return float(f32(init) * _pow32(f32(gamma), f32(n)))

    return schedule


def cosine_schedule(init: float, decay_steps: int, alpha: float
                    ) -> Schedule:
    """optax.cosine_decay_schedule(init, decay_steps, alpha): the half
    cosine from init to alpha * init over ``decay_steps`` updates, then
    held at alpha * init (``CosineAnnealingLR`` would climb again)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine schedule needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(n: int) -> float:
        c = f32(min(n, decay_steps))
        cos = f32(math.cos(np.float64(f32(f32(math.pi) * c)
                                      / f32(decay_steps))))
        decayed = f32(1 - alpha) * (f32(0.5) * (f32(1.0) + cos)) + f32(alpha)
        return float(f32(init) * decayed)

    return schedule


def linear_schedule(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule(init, end, steps): from init to end over
    ``steps`` updates, then held at end."""
    if steps <= 0:
        return lambda n: float(f32(init))

    def schedule(n: int) -> float:
        frac = f32(1.0) - f32(min(max(n, 0), steps)) / f32(steps)
        return float(f32(init - end) * frac + f32(end))

    return schedule


def create_schedule_from_config(scheduler_cfg: Dict[str, Any],
                                base_lr: float) -> Schedule:
    """The reference's scheduler schema (reference: training/utils.py:
    100-115; InverseLR from k-diffusion, the rest named after
    torch.optim.lr_scheduler) as a schedule of the update count, per step
    as the reference's interval="step"."""
    kind = scheduler_cfg["type"]
    c = dict(scheduler_cfg.get("config", {}))
    if kind == "InverseLR":
        return inverse_lr_schedule(
            base_lr, inv_gamma=c.get("inv_gamma", 200000.0),
            power=c.get("power", 0.5), warmup=c.get("warmup", 0.999))
    if kind == "ExponentialLR":
        return exponential_schedule(base_lr, c["gamma"])
    if kind == "CosineAnnealingLR":
        return cosine_schedule(base_lr, c["T_max"],
                               c.get("eta_min", 0.0) / max(base_lr, 1e-12))
    if kind == "LinearLR":
        return linear_schedule(base_lr * c.get("start_factor", 1.0 / 3.0),
                               base_lr * c.get("end_factor", 1.0),
                               c.get("total_iters", 5))
    raise NotImplementedError(f"Unknown scheduler type: {kind}")


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop's update (``torch.optim.RMSprop`` divides by sqrt(nu)
    + eps, optax by sqrt(nu + eps)): nu <- alpha nu + (1 - alpha) g^2,
    u = -lr g / sqrt(nu + eps), then the momentum trace t <- u + momentum
    t (after the rate, as optax chains it), p <- p + t."""

    def __init__(self, params, lr: float, alpha: float = 0.99,
                 momentum: float = 0.0, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, alpha=alpha, momentum=momentum,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            a, m = group["alpha"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                g = p.grad
                st["nu"].mul_(a).add_((1 - a) * g * g)
                u = -group["lr"] * g * torch.rsqrt(st["nu"] + group["eps"])
                st["trace"].mul_(m).add_(u)
                p.add_(st["trace"])


class ScheduledOptimizer:
    """``optimizer_cls(params, lr=lr, **kwargs)`` under ``schedule`` (None:
    the constant ``lr``), after a global-norm clip when ``clip`` > 0 (no
    epsilon, as optax's). ``step(grads)`` applies one update; ``count`` is
    optax's update count."""

    def __init__(self, params: Sequence[Tensor], optimizer_cls, lr: float,
                 schedule: Optional[Schedule] = None, clip: float = 0.0,
                 **kwargs):
        self.params = list(params)
        self.clip = clip
        self.optimizer = optimizer_cls(self.params, lr=lr, **kwargs)
        factor = ((lambda n: schedule(n) / lr) if schedule is not None
                  else (lambda n: 1.0))
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.optimizer,
                                                          factor)

    @property
    def count(self) -> int:
        """Updates applied (optax's count)."""
        return self.schedule.last_epoch

    @torch.no_grad()
    def step(self, grads: Sequence[Tensor]) -> None:
        grads = list(grads)
        if self.clip > 0:
            clip_by_global_norm_(grads, self.clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.schedule.step()

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.schedule.load_state_dict(state["schedule"])


class ClipAdamW(ScheduledOptimizer):
    """``chain(clip_by_global_norm(clip), adamw(inverse_lr_schedule(lr),
    b1=0.8, b2=0.99, weight_decay=1e-3))`` as optax builds it for the LDM
    and VAE-GAN trainers; ``clip`` 0 leaves the clip out (the VAE-GAN's
    default).

    The update is ``torch.optim.AdamW`` (eps 1e-8 outside the square root,
    bias correction by the applied updates, and decoupled decay
    p (1 - lr wd), which equals optax's p - lr (update + wd p))."""

    def __init__(self, params: Sequence[Tensor], lr: float,
                 clip: float = 0.0):
        super().__init__(params, torch.optim.AdamW, lr,
                         inverse_lr_schedule(lr), clip, betas=(0.8, 0.99),
                         eps=1e-8, weight_decay=1e-3, foreach=True)


def adamw(params: Sequence[Tensor], lr: float, b1: float = 0.9,
          b2: float = 0.999, weight_decay: float = 1e-4,
          clip: float = 0.0) -> ScheduledOptimizer:
    """``optax.adamw(lr, b1, b2, weight_decay=...)`` at a constant rate,
    after ``clip_by_global_norm(clip)`` when ``clip`` > 0 (the diffusion
    and LM trainers' optimizers)."""
    return ScheduledOptimizer(params, torch.optim.AdamW, lr, clip=clip,
                              betas=(b1, b2), eps=1e-8,
                              weight_decay=weight_decay, foreach=True)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """An optimizer read from a config, before its parameters: ``build``
    makes the ``ScheduledOptimizer``."""

    kind: str
    lr: float
    schedule: Optional[Schedule]
    kwargs: Dict[str, Any]

    def build(self, params: Sequence[Tensor], clip: float = 0.0
              ) -> ScheduledOptimizer:
        classes = {"AdamW": torch.optim.AdamW, "Adam": torch.optim.Adam,
                   "SGD": torch.optim.SGD, "RMSprop": OptaxRMSprop}
        return ScheduledOptimizer(params, classes[self.kind], self.lr,
                                  self.schedule, clip, **self.kwargs)


def create_optimizer_from_config(opt_cfg: Dict[str, Any],
                                 scheduler_cfg: Optional[Dict[str, Any]]
                                 = None) -> OptimizerSpec:
    """The reference's optimizer schema (reference: training/utils.py:
    79-98) as optax's transforms read it: AdamW and FusedAdam are
    decoupled AdamW; Adam's ``weight_decay`` is coupled (optax's
    ``add_decayed_weights`` before ``adam``, torch's Adam ``weight_decay``);
    SGD with ``momentum`` and ``nesterov``; RMSprop is optax's
    (``OptaxRMSprop``, decay ``alpha``). ``amsgrad`` and ``eps`` are
    dropped, as the JAX package drops them (optax's eps 1e-8 stays)."""
    kind = opt_cfg["type"]
    c = dict(opt_cfg.get("config", {}))
    lr = c.pop("lr", 1e-4)
    schedule = (None if scheduler_cfg is None
                else create_schedule_from_config(scheduler_cfg, lr))
    b1, b2 = c.pop("betas", (0.9, 0.999))
    wd = c.pop("weight_decay", 0.0)
    if kind in ("AdamW", "FusedAdam"):
        return OptimizerSpec("AdamW", lr, schedule, dict(
            betas=(b1, b2), eps=1e-8, weight_decay=wd, foreach=True))
    if kind == "Adam":
        return OptimizerSpec("Adam", lr, schedule, dict(
            betas=(b1, b2), eps=1e-8, weight_decay=wd, foreach=True))
    if kind == "SGD":
        # optax's nesterov acts on its momentum trace: none without one
        momentum = c.get("momentum") or 0.0
        return OptimizerSpec("SGD", lr, schedule, dict(
            momentum=momentum,
            nesterov=bool(momentum) and bool(c.get("nesterov", False))))
    if kind == "RMSprop":
        return OptimizerSpec("RMSprop", lr, schedule, dict(
            alpha=c.get("alpha", 0.99), momentum=c.get("momentum", 0.0)))
    raise NotImplementedError(f"Unknown optimizer type: {kind}")
