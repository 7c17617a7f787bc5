"""The learning-rate schedule and the optimizer of the stable-audio
training wrappers, the LDM decoder finetune and the VAE-GAN (port of
ditsep_tpu/training/schedules.py:7-20 and the optax chains of
ditsep_tpu/training/{ldm,autoencoder}.py).

The config-driven builders (``create_{schedule,optimizer}_from_config``)
go with the stable-audio JSON factory (ROADMAP A16).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ditsep_tpu_torch.training.diffsep import clip_by_global_norm_

Tensor = torch.Tensor


def inverse_lr_schedule(base_lr: float, inv_gamma: float = 200000.0,
                        power: float = 0.5, warmup: float = 0.999
                        ) -> Callable[[int], float]:
    """k-diffusion's InverseLR, exponential warmup then inverse-power
    decay, at optax's update count n (0 on the first update):

        lr(n) = base_lr * (1 - warmup^(n+1)) * (1 + n/inv_gamma)^-power

    evaluated in float32, as optax evaluates it (1 - 0.999 is 1.3e-5 off
    in float32, so a float64 schedule would part from JAX's there)."""
    f = np.float32
    base, gamma, wu, pw = f(base_lr), f(inv_gamma), f(warmup), f(power)

    def schedule(n: int) -> float:
        s = f(n)
        w = f(1.0) - wu ** (s + f(1.0)) if warmup > 0 else f(1.0)
        return float(base * w * (f(1.0) + s / gamma) ** -pw)

    return schedule


class ClipAdamW:
    """``chain(clip_by_global_norm(clip), adamw(inverse_lr_schedule(lr),
    b1=0.8, b2=0.99, weight_decay=1e-3))`` as optax builds it for the LDM
    and VAE-GAN trainers, on a list of float32 parameters updated in
    place; ``clip`` 0 leaves the clip out (the VAE-GAN's default).

    The update is ``torch.optim.AdamW`` (eps 1e-8 outside the square root,
    bias correction by the applied updates, and decoupled decay
    p (1 - lr wd), which equals optax's p - lr (update + wd p)) under a
    ``LambdaLR`` that sets each update's rate to the schedule at the count
    of updates before it. The clip is ``ClipAdam``'s
    (training/diffsep.py)."""

    def __init__(self, params: Sequence[Tensor], lr: float,
                 clip: float = 0.0):
        self.params = list(params)
        self.clip = clip
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.8, 0.99),
                                       eps=1e-8, weight_decay=1e-3,
                                       foreach=True)
        rate = inverse_lr_schedule(lr)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda n: rate(n) / lr)

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
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.schedule.step()

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(),
                "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.schedule.load_state_dict(state["schedule"])
