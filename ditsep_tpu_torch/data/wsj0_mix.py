"""WSJ0-mix / LibriMix datasets, the synthetic mixture sets, the collator and
the bucketed batch iterator (the port's copy of ditsep_tpu/data/wsj0_mix.py
:22-418, without the C collation library: its numpy path gives the same
arrays).

Host-side numpy throughout. The loader pads every batch to a length bucket
(``multiple`` samples, or 64-frame STFT blocks with ``frame_spec``), so
the shapes the model sees repeat.
"""
from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ditsep_tpu_torch.data.audio import read_wav
from ditsep_tpu_torch.ops.stft import n_frames_prepadded

# split name maps (reference: src/datasets/wsj0_mix.py:16-24)
SPLITS_WSJ = {"train": "tr", "val": "cv", "test": "tt",
              "librimix_train-360": "train-360", "librimix_dev": "dev",
              "librimix_test": "test"}


def wav_num_samples(path: str) -> int:
    """Per-channel sample count from the WAV header alone; a full decode
    for containers the stdlib reader rejects."""
    import wave

    try:
        with wave.open(path, "rb") as w:
            return w.getnframes()
    except (wave.Error, EOFError):
        return int(np.atleast_2d(read_wav(path)[0]).shape[-1])


@dataclasses.dataclass
class WSJ0Mix:
    """2/3-speaker mixtures in the wsj0-mix or LibriMix directory layout.
    Items: (mix (1, T), targets (n_spkr, T)) float32 numpy; training items
    are cropped at random to ``max_len_s``."""

    path: str
    n_spkr: int = 2
    cut: str = "max"
    split: str = "librimix_test"
    fs: int = 8000
    max_len_s: Optional[float] = None
    rng_seed: int = 0

    def __post_init__(self):
        split_dir = SPLITS_WSJ.get(self.split, self.split)
        root = Path(self.path)
        if "libri" in self.split:
            base = (root / f"Libri{self.n_spkr}Mix" / f"wav{self.fs//1000}k"
                    / self.cut / split_dir)
            self.mix_dir = base / "mix_both"
            if not self.mix_dir.exists():
                self.mix_dir = base / "mix_clean"
        else:
            base = (root / f"{self.n_spkr}speakers"
                    / f"wav{self.fs//1000}k" / self.cut / split_dir)
            self.mix_dir = base / "mix"
        self.src_dirs = [base / f"s{i+1}" for i in range(self.n_spkr)]
        self.files = (sorted(f for f in os.listdir(self.mix_dir)
                             if f.endswith(".wav"))
                      if self.mix_dir.exists() else [])
        self._rng = np.random.default_rng(self.rng_seed)

    def __len__(self) -> int:
        return len(self.files)

    def item_length(self, idx: int) -> int:
        """Sample count of item ``idx`` from the WAV header only."""
        t = wav_num_samples(str(self.mix_dir / self.files[idx]))
        if self.max_len_s is not None:
            t = min(t, int(self.max_len_s * self.fs))
        return t

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        fname = self.files[idx]
        mix = np.atleast_2d(read_wav(str(self.mix_dir / fname))[0])
        srcs = [read_wav(str(d / fname))[0] for d in self.src_dirs]
        tgt = np.stack([np.atleast_1d(s).reshape(-1) for s in srcs])
        mix = mix.reshape(1, -1)
        if self.max_len_s is not None:  # random crop
            max_len = int(self.max_len_s * self.fs)
            t = mix.shape[-1]
            if t > max_len:
                start = int(self._rng.integers(0, t - max_len + 1))
                mix = mix[:, start:start + max_len]
                tgt = tgt[:, start:start + max_len]
        return mix, tgt


@dataclasses.dataclass
class SyntheticMixDataset:
    """Deterministic synthetic mixtures, for runs without data on disk:
    band-split noise sources (lowpass for source 0, its highpass
    complement for source 1, band-pass beyond) with a slow amplitude
    modulation, so separation is well-posed. The same arrays as the JAX
    package's for the same arguments."""

    n_items: int = 16
    n_spkr: int = 2
    fs: int = 8000
    min_len_s: float = 2.0
    max_len_s: float = 6.0
    seed: int = 0

    def __len__(self):
        return self.n_items

    def item_length(self, idx: int) -> int:
        """Length without generating the audio (the first draw of the
        item's rng stream)."""
        rng = np.random.default_rng(self.seed + idx)
        return int(rng.uniform(self.min_len_s, self.max_len_s) * self.fs)

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        t = int(rng.uniform(self.min_len_s, self.max_len_s) * self.fs)
        srcs = []
        for s in range(self.n_spkr):
            x = rng.standard_normal(t).astype(np.float32)
            k = int(rng.integers(12, 24))
            low = np.convolve(x, np.ones(k, np.float32) / k, mode="same")
            if s == 0:
                x = low
            elif s == 1:
                x = x - low
            else:
                k2 = int(rng.integers(3, 6))
                mid = np.convolve(x, np.ones(k2, np.float32) / k2,
                                  mode="same")
                x = mid - low
            env = 0.5 + 0.5 * np.sin(
                2 * np.pi * rng.uniform(0.5, 2.0)
                * np.arange(t) / self.fs + rng.uniform(0, 6.28))
            x = x * env.astype(np.float32)
            srcs.append(0.3 * x / (np.std(x) + 1e-6) * rng.uniform(0.5, 1.0))
        tgt = np.stack(srcs)
        mix = tgt.sum(axis=0, keepdims=True)
        return mix.astype(np.float32), tgt.astype(np.float32)


@dataclasses.dataclass
class SyntheticTonalMixDataset:
    """Deterministic harmonic-tone mixtures, for the latent pipeline's
    tests and learning loops: each source a sum of harmonics of a slowly
    gliding fundamental with a slow amplitude modulation, a signal of tens
    of degrees of freedom a second that a compressive VAE bottleneck can
    carry (the band-split noise of ``SyntheticMixDataset`` cannot pass a
    64x-compressed latent). The sources stay separable by their disjoint
    f0 ranges (about 100-170, 380-640 and 950-1600 Hz by source index).
    The same arrays as the JAX package's for the same arguments."""

    n_items: int = 16
    n_spkr: int = 2
    fs: int = 8000
    min_len_s: float = 2.0
    max_len_s: float = 6.0
    seed: int = 0

    def __len__(self):
        return self.n_items

    def item_length(self, idx: int) -> int:
        """Length without generating the audio (the first draw of the
        item's rng stream)."""
        rng = np.random.default_rng(self.seed + idx)
        return int(rng.uniform(self.min_len_s, self.max_len_s) * self.fs)

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        t_len = int(rng.uniform(self.min_len_s, self.max_len_s) * self.fs)
        t = np.arange(t_len, dtype=np.float64) / self.fs
        srcs = []
        for s in range(self.n_spkr):
            base = 100.0 * (3.8 ** s)
            f0 = rng.uniform(base, 1.7 * base)
            # a slow vibrato makes f0 a trajectory, not a constant
            vib = 1.0 + 0.02 * np.sin(
                2 * np.pi * rng.uniform(0.5, 2.0) * t + rng.uniform(0, 6.28))
            phase = 2 * np.pi * np.cumsum(f0 * vib) / self.fs
            n_harm = max(1, min(6, int(0.9 * self.fs / 2 / (1.7 * base))))
            x = np.zeros(t_len)
            for h in range(1, n_harm + 1):
                x += np.sin(h * phase + rng.uniform(0, 6.28)) / h
            env = 0.5 + 0.5 * np.sin(
                2 * np.pi * rng.uniform(0.5, 2.0) * t + rng.uniform(0, 6.28))
            x = (x * env).astype(np.float32)
            srcs.append(0.3 * x / (np.std(x) + 1e-6) * rng.uniform(0.5, 1.0))
        tgt = np.stack(srcs)
        mix = tgt.sum(axis=0, keepdims=True)
        return mix.astype(np.float32), tgt.astype(np.float32)


def max_collator(batch: Sequence[Tuple[np.ndarray, ...]],
                 pad_to: Optional[int] = None, align: str = "center"):
    """Pad every signal to the longest (or to ``pad_to``) and stack, field
    by field; padding centered (the reference's training collator) or, with
    ``align='left'``, all at the end. Centred float32 (C, T) fields go
    through the native library when it is built."""
    max_len = max(b[0].shape[-1] for b in batch)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    out: List[np.ndarray] = []
    for i in range(len(batch[0])):
        field = [item[i] for item in batch]
        native_out = (_native_collate_center(field, max_len)
                      if align == "center" else None)
        if native_out is not None:
            out.append(native_out)
            continue
        arrs = []
        for x in field:
            pad = max_len - x.shape[-1]
            lo = 0 if align == "left" else pad // 2
            arrs.append(np.pad(x, [(0, 0)] * (x.ndim - 1)
                               + [(lo, pad - lo)]))
        out.append(np.stack(arrs))
    return tuple(out)


def _native_collate_center(field: Sequence[np.ndarray], max_len: int
                           ) -> Optional[np.ndarray]:
    """Centred collation of one batch field through the native library
    (native/ditsep_io.cpp ditsep_collate_center): each (C, T) item's
    channels as mono rows into one (sum C, max_len) buffer, reshaped back.
    None (the numpy path) without the library or for a field that is not
    uniform float32 (C, T)."""
    from ditsep_tpu_torch import native

    if not all(x.ndim == 2 and x.dtype == np.float32 for x in field):
        return None
    c = field[0].shape[0]
    if any(x.shape[0] != c for x in field):
        return None
    rows = [x[j] for x in field for j in range(c)]
    flat = native.collate_center(rows, max_len)
    if flat is None:
        return None
    return flat.reshape(len(field), c, max_len)


def length_buckets(lengths: Sequence[int], n_buckets: int = 8,
                   multiple: int = 2048) -> List[int]:
    """Bucket boundaries (padded lengths) from the length distribution's
    quantiles, rounded up to ``multiple``."""
    qs = np.quantile(np.asarray(lengths), np.linspace(0, 1, n_buckets + 1))
    return sorted({int(math.ceil(q / multiple)) * multiple for q in qs[1:]})


@dataclasses.dataclass
class BucketedLoader:
    """Batch iterator with length buckets: every batch is (batch_size, ...,
    bucket_len).

    ``frame_spec`` (n_fft, hop, block) puts the boundaries on the score
    model's 64-frame STFT blocks (at most ``n_buckets`` of them, the least
    populated merged upward) instead of sample multiples; ``align`` is the
    collator's; ``yield_counts`` appends each batch's real item count (a
    remainder batch is filled up by cycling its real items)."""

    dataset: object
    batch_size: int = 8
    n_buckets: int = 8
    multiple: int = 2048
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = False
    frame_spec: Optional[Tuple[int, int, int]] = None
    align: str = "center"
    yield_counts: bool = False

    def __post_init__(self):
        get_len = getattr(self.dataset, "item_length", None)
        self._lengths = ([get_len(i) for i in range(len(self.dataset))]
                         if get_len else
                         [self.dataset[i][0].shape[-1]
                          for i in range(len(self.dataset))])
        if self.frame_spec is not None:
            n_fft, hop, block = self.frame_spec
            hist: dict = {}
            for length in self._lengths:
                k = -(-n_frames_prepadded(length, n_fft, hop) // block)
                hist[k] = hist.get(k, 0) + 1
            moved = 0
            while len(hist) > self.n_buckets:
                order = sorted(hist)
                cand = min(order[:-1], key=lambda k: hist[k])
                nxt = order[order.index(cand) + 1]
                cnt = hist.pop(cand)
                moved += cnt
                hist[nxt] = hist.get(nxt, 0) + cnt
            if moved:
                print(f"[BucketedLoader] merged {moved} items into higher "
                      f"frame blocks (n_buckets={self.n_buckets}); their "
                      f"padded quiet fraction exceeds native")
            # the most samples whose frames fit k blocks
            self._bounds = [hop * block * k - 1 - (n_fft - hop)
                            for k in sorted(hist)]
        else:
            self._bounds = length_buckets(self._lengths, self.n_buckets,
                                          self.multiple)

    def bucket_of(self, length: int) -> int:
        for b in self._bounds:
            if length <= b:
                return b
        return self._bounds[-1]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        pools: dict = {}
        for idx in order:
            b = self.bucket_of(self._lengths[idx])
            pools.setdefault(b, []).append(idx)
            if len(pools[b]) == self.batch_size:
                items = [self.dataset[i] for i in pools.pop(b)]
                out = max_collator(items, pad_to=b, align=self.align)
                yield out + (len(items),) if self.yield_counts else out
        if not self.drop_remainder:
            for b, idxs in pools.items():
                if not idxs:
                    continue
                items = [self.dataset[i] for i in idxs]
                n_real = len(items)
                while len(items) < self.batch_size:
                    items.append(items[len(items) % n_real])
                out = max_collator(items, pad_to=b, align=self.align)
                yield out + (n_real,) if self.yield_counts else out
