"""Cached latents for decoder finetuning (port of ditsep_tpu/data/
latent_ds.py; reference: src/datasets/latent_ds.py and the cache writer
src/ldm.py:296-389).

The files are the JAX package's, so either package reads the other's
cache: ``latent_%06d.npz`` holding ``latent`` (n_src, D, Tl) float32 and,
when given, ``targets`` (n_src, T) float32, the exact crop the latent was
made from; ``metadata.npz`` holding ``indices`` (int64) and any extra
arrays (``base_indices``: the source item of each cache entry).
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def save_latent_cache(out_dir: str, index: int, latent: np.ndarray,
                      targets: Optional[np.ndarray] = None) -> None:
    """Store one cached latent, and with ``targets`` the waveform crop it
    was encoded from (a random-cropping dataset draws a new crop on each
    access, so re-reading it later would pair the latent with another)."""
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    arrays = {"latent": np.asarray(latent, np.float32)}
    if targets is not None:
        arrays["targets"] = np.asarray(targets, np.float32)
    np.savez(os.path.join(out_dir, f"latent_{index:06d}.npz"), **arrays)


def save_latent_metadata(out_dir: str, indices,
                         extra: Optional[dict] = None) -> None:
    """Write or refresh ``metadata.npz``."""
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    np.savez(os.path.join(out_dir, "metadata.npz"),
             indices=np.asarray(list(indices), np.int64), **(extra or {}))


@dataclasses.dataclass
class LatentDataset:
    """Items (targets (n_src, T), latent (n_src, D, Tl)): the latent from
    the cache, the targets stored with it or, for a cache without them,
    from ``base_dataset`` at the entry's source item."""

    cache_dir: str
    base_dataset: object = None
    cache_size: int = 32  # entries kept in memory

    def __post_init__(self):
        meta = np.load(os.path.join(self.cache_dir, "metadata.npz"))
        self.indices = meta["indices"]
        self.base_indices = (meta["base_indices"]
                             if "base_indices" in meta else self.indices)
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if i in self._cache:
            latent, tgt = self._cache[i]
        else:
            data = np.load(os.path.join(
                self.cache_dir, f"latent_{int(self.indices[i]):06d}.npz"))
            latent = data["latent"]
            tgt = data["targets"] if "targets" in data else None
            if len(self._cache) < self.cache_size:
                self._cache[i] = (latent, tgt)
        if tgt is None:
            _, tgt = self.base_dataset[int(self.base_indices[i])]
        return tgt, latent
