"""Audio language-model training (port of ditsep_tpu/training/lm.py;
reference: stable-audio-tools training/lm.py:20-77,115-180
AudioLanguageModelTrainingWrapper): AdamW (0.9, 0.95, weight decay 0.1),
after an optional global-norm clip, over ``models.lm.lm_loss``, the
per-codebook masked cross-entropy in the pattern's layout. The EMA decays
by 0.998995 a step, the per-step equivalent of the reference's
ema_pytorch beta 0.99 every 10 steps. The codec that made the tokens is
frozen outside the trainer, as in the reference (lm.py:34).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ditsep_tpu_torch.models.lm import AudioLM, lm_loss
from ditsep_tpu_torch.training.diffsep import TrainState
from ditsep_tpu_torch.training.diffusion import (
    apply_gradient_update, init_train_state, model_grads,
)
from ditsep_tpu_torch.training.schedules import adamw

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMTrainer:
    """Next-token training over multi-codebook token grids (B, Q, T);
    ``pattern`` None: the model's delay pattern."""

    model: AudioLM
    pattern: Any = None
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    ema_decay: float = 0.998995
    clip_grad_norm: float = 0.0

    def make_optimizer(self, params):
        return adamw(params, self.lr, self.b1, self.b2, self.weight_decay,
                     clip=self.clip_grad_norm)

    def init_state(self) -> TrainState:
        return init_train_state(self.model, self.make_optimizer)

    def loss(self, tokens: Tensor, *, model: Optional[AudioLM] = None
             ) -> Tensor:
        return lm_loss(self.model if model is None else model, tokens,
                       self.pattern)

    def train_step(self, state: TrainState, tokens: Tensor
                   ) -> Tuple[TrainState, Dict]:
        loss, grads = model_grads(lambda: self.loss(tokens,
                                                    model=state.model),
                                  state.model)
        return apply_gradient_update(state, loss, grads, self.ema_decay)
