"""Local audio datasets, pre-encoded latents and augmentations (port of
ditsep_tpu/data/dataset.py; reference: stable-audio-tools
data/dataset.py:26-960 SampleDataset / PreEncodedDataset and
data/utils.py:10-121).

Host-side numpy, as the JAX package's: items are numpy arrays, collated by
the loaders of ``data/webdataset.py``; the caller moves batches to the
device. Every random draw comes from an ``np.random.Generator`` in the
order the JAX package makes it, so the same seed gives the same crops and
flips.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ditsep_tpu_torch.data.audio import read_wav


# ------------------------------------------------------- augmentations ----
@dataclasses.dataclass
class PadCropNormalized:
    """Random crop (or zero pad) to ``n_samples``; returns the chunk, the
    crop's start relative to the length, and the length."""

    n_samples: int
    randomize: bool = True

    def __call__(self, rng: np.random.Generator, audio: np.ndarray):
        c, t = audio.shape
        n = self.n_samples
        if t > n:
            start = int(rng.integers(0, t - n + 1)) if self.randomize else 0
            chunk = audio[:, start:start + n]
        else:
            start = 0
            chunk = np.pad(audio, ((0, 0), (0, n - t)))
        return chunk.astype(np.float32), start / max(t, 1), t


def phase_flipper(rng: np.random.Generator, audio: np.ndarray,
                  p: float = 0.5) -> np.ndarray:
    """Negate the audio with probability ``p``."""
    return -audio if rng.uniform() < p else audio


def mono(audio: np.ndarray) -> np.ndarray:
    """(C, T) -> (1, T), the channel mean."""
    return audio.mean(axis=0, keepdims=True) if audio.ndim == 2 else audio


def stereo(audio: np.ndarray) -> np.ndarray:
    """(1, T) duplicated to (2, T); more channels cut to two."""
    a = np.atleast_2d(audio)
    if a.shape[0] == 1:
        return np.repeat(a, 2, axis=0)
    return a[:2]


def volume_norm(rng: np.random.Generator, audio: np.ndarray,
                db_range: Tuple[float, float] = (-6.0, 0.0)) -> np.ndarray:
    """Scale to a random peak level in ``db_range`` dB (silence as it is)."""
    peak = np.abs(audio).max()
    if peak < 1e-8:
        return audio
    target_db = rng.uniform(*db_range)
    return audio / peak * (10.0 ** (target_db / 20.0))


# ------------------------------------------------------------ datasets ----
@dataclasses.dataclass
class SampleDataset:
    """The audio files under ``paths`` (sorted within each folder),
    randomly cropped to ``sample_size``. Items: (audio (C, sample_size),
    metadata dict)."""

    paths: Sequence[str]
    sample_size: int = 65536
    force_channels: str = "mono"  # 'mono' | 'stereo'
    exts: Tuple[str, ...] = (".wav",)
    seed: int = 0
    random_crop: bool = True
    augment_phase: bool = True

    def __post_init__(self):
        self.files: List[str] = []
        for p in self.paths:
            for root, _, names in os.walk(p):
                for n in sorted(names):
                    if n.lower().endswith(self.exts):
                        self.files.append(os.path.join(root, n))
        self._rng = np.random.default_rng(self.seed)
        self._crop = PadCropNormalized(self.sample_size, self.random_crop)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        path = self.files[idx]
        audio, fs = read_wav(path)
        audio = np.atleast_2d(audio)
        audio = (mono(audio) if self.force_channels == "mono"
                 else stereo(audio))
        chunk, rel_start, total = self._crop(self._rng, audio)
        if self.augment_phase:
            chunk = phase_flipper(self._rng, chunk)
        meta = {"path": path, "sample_rate": fs,
                "seconds_start": rel_start * total / fs,
                "seconds_total": total / fs}
        return chunk, meta


@dataclasses.dataclass
class PreEncodedDataset:
    """Pre-encoded latents on disk: every ``.npy`` / ``.npz`` under
    ``path``, sorted; an ``.npz`` gives its ``latent_key`` array."""

    path: str
    latent_key: str = "latent"

    def __post_init__(self):
        self.files = sorted(str(p) for p in Path(self.path).glob("**/*")
                            if p.suffix in (".npy", ".npz"))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        f = self.files[idx]
        if f.endswith(".npz"):
            return np.load(f)[self.latent_key]
        return np.load(f)
