"""Streaming separation: bounded-latency incremental chunked sampling (port
of ditsep_tpu/serving/streaming.py).

The real-time counterpart of the offline long-form path
(``inference/longform.py``): audio is pushed in blocks of any size, and
separated stems come back as soon as they are FINAL (no later window can
rewrite them). Separation itself is the same fixed-window separator: every
window has one shape.

Differences from the offline stitcher, by causality:

* The offline path right-aligns a tail window at the stream end, which
  may rewrite samples arbitrarily far back, impossible once they have been
  emitted. ``flush()`` instead zero-pads the final partial window in place
  and trims, passing the valid length through (``pass_lengths``) so that
  mask_padding models exclude the pad from their statistics
  (docs/pad_dilution_r03.md).
* Worst-case output latency is ``chunk_samples + hop`` input samples (a
  sample arriving just after a window boundary waits for that window to
  fill, and is final once the next window starts after it):
  ``latency_samples``.

Permutation ambiguity between windows is resolved as the offline path
does: per window, the source permutation maximizing the overlap's
correlation with the already-stitched tail, then a linear crossfade.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ditsep_tpu_torch.inference.longform import align_permutation
from ditsep_tpu_torch.utils.device import resolve_device

__all__ = ["StreamingSeparator", "engine_separate_fn"]


def engine_separate_fn(engine) -> Callable:
    """Adapter driving a :class:`StreamingSeparator` through a shared
    :class:`~ditsep_tpu_torch.serving.BatchingEngine`, so N concurrent live
    streams ride batched sampler calls (streams with the same window size
    share the engine's shapes).

    Only the window's VALID samples are submitted: the engine does its own
    frame-block bucket padding (and lengths masking when built with
    ``pass_lengths``), so the streamer's zero-padded flush tail is never
    padded twice. The engine owns the generator (its draws are made per
    batch); the streamer's generator is unused. Build the streamer with
    ``device="cpu"``: the window goes to the engine as host samples."""
    def fn(mix, lengths=None, generator=None):
        flat = np.asarray(torch.as_tensor(mix).cpu(), np.float32).reshape(-1)
        valid = (int(torch.as_tensor(lengths).reshape(-1)[0])
                 if lengths is not None else flat.shape[-1])
        est = np.asarray(engine.separate(flat[:valid]), np.float32)
        if valid < flat.shape[-1]:
            est = np.concatenate(
                [est, np.zeros((est.shape[0], flat.shape[-1] - valid),
                               np.float32)], axis=-1)
        return est[None]

    return fn


class StreamingSeparator:
    """Push-pull streaming wrapper around a fixed-window separator.

    Parameters
    ----------
    separate_fn:
        ``separate_fn(mix, lengths=None, generator=g) -> est``: ``mix`` a
        (1, 1, chunk_samples) float32 tensor on ``device``, ``est`` a
        (1, n_src, chunk_samples) tensor or array, e.g. a
        ``trainer.separate`` closure, as ``separate_longform`` calls it.
        Called once per window with the SAME shape; ``g`` is
        ``generator``, drawn from in turn.
    chunk_samples / overlap_samples:
        window and overlap; hop = chunk - overlap.
    pass_lengths:
        forward each window's valid sample count as ``lengths`` (1,) int64
        on ``device`` (needed by mask_padding models; only the flush-tail
        window is ever partially valid).
    generator / seed:
        the windows' generator on ``device``; a new one seeded with
        ``seed`` when None.
    device:
        where the windows are handed to ``separate_fn``; the CUDA card
        unless ``"cpu"`` is given.

    Usage::

        s = StreamingSeparator(fn, chunk_samples=40960,
                               overlap_samples=8192, device="cuda")
        for block in audio_blocks:
            stems = s.push(block)   # (n_src, k) newly-final samples
            ...
        stems = s.flush()           # the remainder
    """

    def __init__(self, separate_fn: Callable, *, chunk_samples: int,
                 overlap_samples: int, n_src: int = 2, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 pass_lengths: bool = False, device="cuda"):
        if not 0 <= overlap_samples < chunk_samples:
            raise ValueError("need 0 <= overlap_samples < chunk_samples")
        if overlap_samples == 0 and n_src > 1:
            raise ValueError(
                "overlap_samples must be > 0 for multi-source streams "
                "(permutation alignment needs an overlap)")
        self.device = resolve_device(device)
        self._fn = separate_fn
        self.chunk = int(chunk_samples)
        self.overlap = int(overlap_samples)
        self.hop = self.chunk - self.overlap
        self.n_src = int(n_src)
        self.pass_lengths = bool(pass_lengths)
        self._generator = (torch.Generator(device=self.device).manual_seed(
            int(seed)) if generator is None else generator)

        self._in = np.zeros((0,), np.float32)
        self._pending = []      # blocks not yet merged into _in
        self._pending_n = 0
        self._in_base = 0       # absolute index of _in[0]
        self._out = np.zeros((self.n_src, 0), np.float32)
        self._out_base = 0      # absolute index of _out[:, 0] == emitted
        self._prev_end = 0      # absolute end of the separated region
        self._next_start = 0    # absolute start of the next window
        self._first = True
        self._flushed = False

    # ------------------------------------------------------------ info --
    @property
    def latency_samples(self) -> int:
        """Worst-case input-to-output latency in samples."""
        return self.chunk + self.hop

    @property
    def emitted_samples(self) -> int:
        """Total samples per stem returned so far (before flush)."""
        return self._out_base

    # ------------------------------------------------------------ core --
    def _run(self, window: np.ndarray, valid: int) -> np.ndarray:
        kw = {"generator": self._generator}
        if self.pass_lengths:
            kw["lengths"] = torch.tensor([valid], dtype=torch.int64,
                                         device=self.device)
        est = self._fn(torch.from_numpy(
            np.ascontiguousarray(window[None, None, :])).to(self.device),
            **kw)
        if isinstance(est, torch.Tensor):
            est = est.detach().float().cpu().numpy()
        return np.asarray(est)[0]  # (n_src, chunk)

    def _stitch(self, s: int, est: np.ndarray) -> None:
        """Crossfade window ``est`` (starting at absolute ``s``) onto the
        held tail; extends the separated region to ``s + chunk``."""
        if self._first:
            self._out = est.copy()
            self._first = False
        else:
            ov = self._prev_end - s
            off = s - self._out_base
            perm = align_permutation(self._out[:, off:], est[:, :ov])
            est = est[list(perm)]
            w = np.linspace(0.0, 1.0, ov, dtype=np.float32)
            self._out[:, off:] = (self._out[:, off:] * (1.0 - w)
                                  + est[:, :ov] * w)
            self._out = np.concatenate([self._out, est[:, ov:]], axis=1)
        self._prev_end = s + est.shape[-1]
        self._next_start = s + self.hop

    def _merge_pending(self) -> None:
        if self._pending:
            self._in = np.concatenate([self._in] + self._pending)
            self._pending = []
            self._pending_n = 0

    def _process_ready(self) -> None:
        total = (self._in_base + self._in.shape[-1] + self._pending_n)
        if total < self._next_start + self.chunk:
            return
        self._merge_pending()
        while total >= self._next_start + self.chunk:
            s = self._next_start
            off = s - self._in_base
            est = self._run(self._in[off:off + self.chunk], self.chunk)
            self._stitch(s, est)
            # input below the next window start is never read again
            cut = self._next_start - self._in_base
            if cut > 0:
                self._in = self._in[cut:]
                self._in_base = self._next_start

    def _drain(self, upto: int) -> np.ndarray:
        n = upto - self._out_base
        if n <= 0:
            return np.zeros((self.n_src, 0), np.float32)
        out = self._out[:, :n]
        self._out = self._out[:, n:]
        self._out_base = upto
        return out

    # ------------------------------------------------------------- api --
    def push(self, block) -> np.ndarray:
        """Feed a block of mixture samples ((T,) or (1, T)); returns the
        newly FINAL separated samples (n_src, k), possibly empty."""
        if self._flushed:
            raise RuntimeError("push after flush")
        block = np.asarray(block, np.float32)
        if block.ndim == 2 and block.shape[0] == 1:
            block = block[0]
        if block.ndim != 1:
            raise ValueError(f"expected mono (T,) or (1, T) block, "
                             f"got {block.shape}")
        if block.size:
            self._pending.append(block)
            self._pending_n += block.shape[-1]
        self._process_ready()
        # samples before the next window's start are final: every later
        # window writes >= _next_start
        return self._drain(self._next_start if not self._first else 0)

    def flush(self) -> np.ndarray:
        """End of stream: separate the remaining partial window
        (zero-padded in place, trimmed back) and return everything not
        yet emitted."""
        if self._flushed:
            return np.zeros((self.n_src, 0), np.float32)
        self._flushed = True
        self._merge_pending()
        total = self._in_base + self._in.shape[-1]
        if total > self._prev_end:  # a partial window remains
            s = self._next_start
            valid = total - s
            off = s - self._in_base
            window = np.zeros((self.chunk,), np.float32)
            window[:valid] = self._in[off:off + valid]
            est = self._run(window, valid)
            self._stitch(s, est[:, :valid] if self._first
                         else est)
            if not self._first and self._prev_end > total:
                # trim the zero-pad region off the stitched tail
                keep = total - self._out_base
                self._out = self._out[:, :keep]
                self._prev_end = total
        self._in = np.zeros((0,), np.float32)
        self._in_base = total
        return self._drain(max(total, self._out_base))
