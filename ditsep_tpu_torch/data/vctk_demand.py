"""VCTK-DEMAND (Valentini) speech enhancement as 2-source separation (port
of ditsep_tpu/data/vctk_demand.py): items are (noisy (1, T), [clean, noise]
(2, T)) float32 numpy arrays, noise = noisy - clean.

Both directory layouts are read: the Valentini-native
``{noisy,clean}_{part}set_wav`` and the preprocessed ``{part}/{noisy,
clean}``. The validation split is a seeded 10% holdout of the train files
(at least one file), so train and validation never overlap.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ditsep_tpu_torch.data.audio import read_wav
from ditsep_tpu_torch.data.wsj0_mix import wav_num_samples


def _resolve_dirs(root: Path, part: str) -> Tuple[Path, Path]:
    """(noisy_dir, clean_dir) of a corpus part ('train' or 'test'): the
    first layout whose noisy folder exists, else the Valentini one."""
    candidates = [
        (root / f"noisy_{part}set_wav", root / f"clean_{part}set_wav"),
        (root / part / "noisy", root / part / "clean"),
    ]
    for noisy, clean in candidates:
        if noisy.exists():
            return noisy, clean
    return candidates[0]


@dataclasses.dataclass
class NoisyDataset:
    """``split`` 'train', 'val' (the holdout of the train files) or
    'test'. With ``len_s`` every item is tiled (shorter) or cropped at a
    seeded random start (longer) to len_s seconds."""

    path: str
    split: str = "train"
    fs: int = 16000
    len_s: Optional[float] = 4.0
    rng_seed: int = 0
    val_fraction: float = 0.1

    def __post_init__(self):
        if self.split not in ("train", "val", "test"):
            raise ValueError(f"bad split {self.split!r}")
        part = "test" if self.split == "test" else "train"
        self.noisy_dir, self.clean_dir = _resolve_dirs(Path(self.path), part)
        files: List[str] = []
        if self.noisy_dir.exists():
            files = sorted(f for f in os.listdir(self.noisy_dir)
                           if f.endswith(".wav"))
        if self.split in ("train", "val") and files:
            perm = np.random.default_rng(self.rng_seed).permutation(len(files))
            n_val = max(1, int(len(files) * self.val_fraction))
            keep = perm[:n_val] if self.split == "val" else perm[n_val:]
            files = [files[i] for i in sorted(keep)]
        self.files = files
        self._rng = np.random.default_rng(self.rng_seed)

    def __len__(self) -> int:
        return len(self.files)

    def item_length(self, idx: int) -> int:
        """Sample count of item ``idx`` from the WAV header only."""
        if self.len_s is not None:
            return int(self.len_s * self.fs)
        return wav_num_samples(str(self.noisy_dir / self.files[idx]))

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        f = self.files[idx]
        noisy = read_wav(str(self.noisy_dir / f))[0].reshape(1, -1)
        clean = read_wav(str(self.clean_dir / f))[0].reshape(1, -1)
        if self.len_s is not None:
            target_len = int(self.len_s * self.fs)
            t = noisy.shape[-1]
            if t < target_len:
                reps = -(-target_len // t)
                noisy = np.tile(noisy, (1, reps))[:, :target_len]
                clean = np.tile(clean, (1, reps))[:, :target_len]
            elif t > target_len:
                s = int(self._rng.integers(0, t - target_len + 1))
                noisy = noisy[:, s:s + target_len]
                clean = clean[:, s:s + target_len]
        tgt = np.concatenate([clean, noisy - clean], axis=0)
        return noisy.astype(np.float32), tgt.astype(np.float32)
