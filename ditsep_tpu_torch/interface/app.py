"""Functional core of the demo interface, free of any UI framework (port of
ditsep_tpu/interface/app.py:33-62).

Each process function is a plain callable over numpy audio and scalar
knobs, so the demo is testable without a browser. The port has the
separation backend and ``spectrogram_preview``; the autoencoder,
generation and LM backends (``AutoencoderApp``, ``GenerationApp``,
``LMApp``) are not ported yet (ROADMAP A16).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def _to_mono_batch(wav: np.ndarray) -> np.ndarray:
    """(T,) or (T, C) audio -> (1, 1, T) float32, peak-normalized."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:  # (T, C), as decode_wav gives it
        wav = wav.mean(axis=1)
    peak = float(np.abs(wav).max()) or 1.0
    return (wav / max(peak, 1e-6))[None, None, :]


def _peak_norm(x: np.ndarray) -> np.ndarray:
    return x / max(float(np.abs(x).max()), 1e-6)


@dataclasses.dataclass
class SeparationApp:
    """Separation tab backend: a ``DiffSepTrainer`` (its score model on
    the device it runs on) -> process function."""

    trainer: Any
    fs: int = 8000

    def process(self, wav: np.ndarray, n_steps: int = 30,
                snr: float = 0.5, corrector_steps: int = 1,
                seed: int = 0) -> np.ndarray:
        """Separate one mixture: (n_src, T) estimates, peak-normalized.
        ``seed`` seeds a generator on the trainer's device."""
        device = next(self.trainer.model.parameters()).device
        mix = torch.from_numpy(_to_mono_batch(wav)).to(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        est, _ = self.trainer.separate(
            mix, N=int(n_steps), snr=float(snr),
            corrector_steps=int(corrector_steps), generator=generator)
        return _peak_norm(est[0].float().cpu().numpy())


def spectrogram_preview(wav: np.ndarray, fs: int = 8000):
    """Matplotlib spectrogram figure of a waveform, for UI previews."""
    from ditsep_tpu_torch.viz import spectrogram_image

    return spectrogram_image(np.asarray(wav).reshape(-1), fs=fs)
