"""Long-form separation: chunk -> sample -> align -> crossfade-stitch
(port of ditsep_tpu/inference/longform.py).

The separator is a fixed-window model, so a long file is cut into windows
of one size. Each window's sampling orders the sources arbitrarily, so
each window is aligned to the one before it: the source permutation that
maximizes the summed normalized correlation over their overlap, then a
linear crossfade across that overlap. The alignment and the crossfade are
host numpy work between the windows' sampler calls.
"""
from __future__ import annotations

from itertools import permutations
from typing import Callable, List

import numpy as np
import torch

from ditsep_tpu_torch.utils.device import resolve_device


def align_permutation(prev_tail: np.ndarray, cur_head: np.ndarray
                      ) -> tuple:
    """Best source permutation of ``cur_head`` against ``prev_tail``.

    Both are (n_src, O) overlap segments. Returns the permutation ``p``
    (a tuple of source indices) maximizing the summed normalized
    correlation ``sum_i corr(prev[i], cur[p[i]])``, exhaustive over the
    n_src! permutations."""
    n = prev_tail.shape[0]
    a = prev_tail / (np.linalg.norm(prev_tail, axis=-1, keepdims=True)
                     + 1e-9)
    b = cur_head / (np.linalg.norm(cur_head, axis=-1, keepdims=True)
                    + 1e-9)
    corr = a @ b.T  # corr[i, j] = <prev_i, cur_j>
    return max(permutations(range(n)),
               key=lambda p: sum(corr[i, p[i]] for i in range(n)))


def window_starts(n_samples: int, chunk_samples: int,
                  overlap_samples: int) -> List[int]:
    """The windows' first samples: a hop of chunk - overlap, and a last
    window right-aligned at the end when the hops leave a tail; one window
    at 0 when the input fits in one."""
    if n_samples <= chunk_samples:
        return [0]
    hop = chunk_samples - overlap_samples
    starts = list(range(0, n_samples - chunk_samples + 1, hop))
    if starts[-1] + chunk_samples < n_samples:
        starts.append(n_samples - chunk_samples)
    return starts


def separate_longform(
    separate_fn: Callable,
    mix: np.ndarray,
    *,
    chunk_samples: int,
    overlap_samples: int,
    generator: torch.Generator,
    n_src: int = 2,
    pass_lengths: bool = False,
    device="cuda",
) -> np.ndarray:
    """Separate an arbitrarily long mono mixture with a fixed-window
    separator.

    ``separate_fn(chunk, lengths=None, generator=g) -> est``: ``chunk``
    is a (1, 1, chunk_samples) float32 tensor on ``device``, ``est`` a
    (1, n_src, chunk_samples) tensor or array; every window is called with
    the same shape. ``g`` is ``generator`` (on ``device``), drawn from in
    turn. With ``pass_lengths`` the call also gets ``lengths`` (1,) int64,
    the window's valid sample count: a mixture shorter than one window is
    zero-padded, and a masked score model must not count that pad as
    signal.

    ``mix`` is (T,) or (1, T). The windows start every chunk - overlap
    samples, the last one right-aligned at T (its overlap with the one
    before may exceed ``overlap_samples``; the crossfade spans whatever
    overlaps). Returns (n_src, T) float32."""
    device = resolve_device(device)
    mix = np.asarray(mix, np.float32)
    if mix.ndim == 2 and mix.shape[0] == 1:
        mix = mix[0]
    if mix.ndim != 1:
        raise ValueError(
            f"expected mono (T,) or (1, T) mixture, got {mix.shape} — "
            "downmix multichannel audio before separation")
    n_samples = mix.shape[-1]
    if not 0 <= overlap_samples < chunk_samples:
        raise ValueError("need 0 <= overlap_samples < chunk_samples")
    if overlap_samples == 0 and n_src > 1:
        raise ValueError(
            "overlap_samples must be > 0 for multi-source separation: "
            "the zero-length overlap carries no permutation-alignment "
            "signal, so stems would swap sources at chunk boundaries")

    def run(chunk: np.ndarray, valid: int) -> np.ndarray:
        kw = {"generator": generator}
        if pass_lengths:
            kw["lengths"] = torch.tensor([valid], dtype=torch.int64,
                                         device=device)
        est = separate_fn(torch.from_numpy(chunk[None, None, :]).to(device),
                          **kw)
        if isinstance(est, torch.Tensor):
            est = est.detach().float().cpu().numpy()
        return np.asarray(est)[0]  # (n_src, chunk)

    starts = window_starts(n_samples, chunk_samples, overlap_samples)
    if n_samples <= chunk_samples:  # one window: pad, separate, trim
        est = run(np.pad(mix, (0, chunk_samples - n_samples)), n_samples)
        return est[:, :n_samples]

    out = np.zeros((n_src, n_samples), np.float32)
    prev_end = 0
    for ci, s in enumerate(starts):
        est = run(mix[s:s + chunk_samples], chunk_samples)
        if ci == 0:
            out[:, :chunk_samples] = est
        else:
            ov = prev_end - s
            perm = align_permutation(out[:, s:prev_end], est[:, :ov])
            est = est[list(perm)]
            w = np.linspace(0.0, 1.0, ov, dtype=np.float32)
            out[:, s:prev_end] = (out[:, s:prev_end] * (1.0 - w)
                                  + est[:, :ov] * w)
            out[:, prev_end:s + chunk_samples] = est[:, ov:]
        prev_end = s + chunk_samples
    return out
