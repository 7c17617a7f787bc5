"""Demo callbacks: separations logged as audio during training (the port
of ditsep_tpu/training/demo.py:22-27, 132-163).

``fit(callbacks=...)`` calls ``cb(logger, step, trainer, state,
generator)`` after each step where ``cb.due(step)``; the audio lands in
the ``MetricsLogger``'s TensorBoard or wandb sink. The JAX loop swallows
any failure of a callback; here only the logging is guarded, so that a
separation (and its kernels) that fails stops the run. The autoencoder,
diffusion and LM callbacks and ``create_demo_callback_from_config`` go
with their models (ROADMAP A16.3-A16.4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


def _log_wavs(logger, tag: str, audio, step: int, fs: int,
              limit: int) -> None:
    """``audio`` (B, ...) as ``tag/i``, one wav an item, the first
    ``limit`` items."""
    a = (audio.detach().float().cpu().numpy()
         if isinstance(audio, torch.Tensor) else np.asarray(audio))
    for i in range(min(a.shape[0], limit)):
        logger.log_audio(f"{tag}/{i}", a[i].reshape(-1), step, fs=fs)


@dataclasses.dataclass(frozen=True)
class SeparationDemoCallback:
    """Separate a fixed demo batch every ``demo_every`` steps with the EMA
    weights and log the mixtures, the estimates and the targets
    (``demo/mix/i``, then ``demo/est_{s}/i`` and ``demo/target_{s}/i`` by
    source)."""

    demo_batch: Any  # (mix (B, 1, T), target (B, n, T)) numpy arrays
    demo_every: int = 2000
    sample_rate: int = 8000
    max_num_sample: int = 2
    sampler_N: Optional[int] = None  # None: the trainer's N

    def due(self, step: int) -> bool:
        return self.demo_every > 0 and step % self.demo_every == 0

    def __call__(self, logger, step: int, trainer, state,
                 generator: torch.Generator) -> None:
        """Separates on the device of ``state.ema``, drawing from
        ``generator``; ``trainer.separate(mix, model=, generator=[, N=])``
        returns (estimates, nfe). A failing separation raises; a failing
        log call is printed and counted (``logger.guarded``)."""
        mix, target = self.demo_batch
        device = next(state.ema.parameters()).device
        mix = torch.as_tensor(np.asarray(mix, np.float32), device=device)
        kw = {"N": self.sampler_N} if self.sampler_N else {}
        est, _ = trainer.separate(mix, model=state.ema, generator=generator,
                                  **kw)
        logger.guarded("demo", step, self._log, logger, step, mix, est,
                       np.asarray(target))

    def _log(self, logger, step, mix, est, target) -> None:
        _log_wavs(logger, "demo/mix", mix, step, self.sample_rate,
                  self.max_num_sample)
        for s in range(est.shape[1]):
            _log_wavs(logger, f"demo/est_{s}", est[:, s:s + 1], step,
                      self.sample_rate, self.max_num_sample)
            _log_wavs(logger, f"demo/target_{s}", target[:, s:s + 1], step,
                      self.sample_rate, self.max_num_sample)
