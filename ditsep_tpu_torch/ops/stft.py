"""STFT / iSTFT on ``torch.stft`` / ``torch.istft`` with the semantics of
ditsep_tpu/ops/stft.py: center=True with constant (zero) padding, periodic
Hann window of length n_fft, onesided bins.

The ``length`` rule is torch.istft's own, which the JAX op was written to
match: the output is sliced ``[n_fft//2 : n_fft//2 + length]`` from the
untrimmed overlap-add buffer and zero-padded past its end. The JAX op
divides by 1 where the window envelope is under 1e-11 while torch.istft
raises there; with the periodic Hann 510/128 of the score model no retained
sample falls there (tests/test_torch_ops.py shows it), so torch.istft is
used as it is.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def n_frames_prepadded(length, n_fft: int, hop_length: int):
    """Frame count the score model's STFT gives a ``length``-sample waveform,
    including its n_fft - hop pre-pad. Works on ints and integer tensors."""
    return (length + (n_fft - hop_length)) // hop_length + 1


def frame_block_padded_len(length: int, n_fft: int, hop_length: int,
                           block: int = 64) -> int:
    """Largest sample count whose frame count (``n_frames_prepadded``)
    stays inside the same ``block``-frame block as ``length``. The score
    model zero-pads its frames to a multiple of ``block``, so padding a
    waveform up to this length adds no quiet columns through the U-Net
    (docs/pad_dilution_r03.md); the serving engine's buckets are these
    lengths, as eval/evaluate.py's frame-block buckets are these blocks."""
    frames = n_frames_prepadded(length, n_fft, hop_length)
    blocks = -(-frames // block)
    return hop_length * (block * blocks) - 1 - (n_fft - hop_length)


def _real_dtype(x: Tensor) -> torch.dtype:
    """float64 stays float64 (float64 reference runs); all else computes
    in float32."""
    return torch.float64 if x.dtype in (torch.float64,
                                        torch.complex128) else torch.float32


def _window(n_fft: int, x: Tensor) -> Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=_real_dtype(x),
                             device=x.device)


def stft(x: Tensor, n_fft: int = 510, hop_length: int = 128,
         center: bool = True, normalized: bool = False) -> Tensor:
    """(..., T) real -> (..., F, n_frames) complex64 (complex128 for
    float64), F = n_fft//2 + 1.

    ``normalized`` divides by sqrt(sum(win^2)) (sqrt(3 n_fft / 8) for the
    periodic Hann), as the JAX op does; ``torch.stft(normalized=True)``
    divides by sqrt(n_fft) instead, so it is not used. Without ``center``
    a signal shorter than ``n_fft`` raises, as the JAX op's framing does."""
    if not center and x.shape[-1] < n_fft:
        raise ValueError(
            f"signal length {x.shape[-1]} < n_fft {n_fft}: pad the input "
            "or use center=True")
    lead = x.shape[:-1]
    win = _window(n_fft, x)
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]).to(win.dtype), n_fft, hop_length, n_fft,
        win, center=center, pad_mode="constant",
        normalized=False, onesided=True, return_complex=True)
    if normalized:
        spec = spec / _window_norm(n_fft)
    return spec.reshape(lead + spec.shape[-2:])


@functools.lru_cache(maxsize=None)
def _window_norm(n_fft: int) -> float:
    """sqrt(sum(win^2)) of the periodic Hann, summed in float64 and
    rounded to float32 (the JAX op divides by it in float32)."""
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float32)
    return float(np.float32(np.sqrt((win.double() ** 2).sum().item())))


def istft(spec: Tensor, n_fft: int = 510, hop_length: int = 128,
          center: bool = True, length: Optional[int] = None) -> Tensor:
    """(..., F, n_frames) complex -> (..., T) float32 waveform."""
    n_freq = n_fft // 2 + 1
    if spec.shape[-2] != n_freq:
        raise ValueError(f"expected {n_freq} bins, got {tuple(spec.shape)}")
    lead = spec.shape[:-2]
    x = torch.istft(
        spec.reshape((-1,) + spec.shape[-2:]), n_fft, hop_length, n_fft,
        _window(n_fft, spec), center=center, normalized=False,
        onesided=True, length=length)
    return x.reshape(lead + x.shape[-1:])


def overlap_add(frames: Tensor, hop_length: int) -> Tensor:
    """(..., n_frames, C*hop) -> (..., (n_frames + C - 1)*hop): frame f's
    chunk j (hop samples) added at row f + j. The JAX op's shift-and-sum
    (ditsep_tpu/ops/stft.py:93): chunk j of every frame padded j rows down,
    the C copies summed."""
    h = hop_length
    n_frames, c = frames.shape[-2], frames.shape[-1] // h
    chunks = frames.reshape(frames.shape[:-1] + (c, h))
    total = None
    for j in range(c):
        shifted = F.pad(chunks[..., j, :], (0, 0, j, c - 1 - j))
        total = shifted if total is None else total + shifted
    return total.reshape(frames.shape[:-2] + ((n_frames + c - 1) * h,))
