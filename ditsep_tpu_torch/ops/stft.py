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

from typing import Optional

import torch

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


def _window(n_fft: int, x: Tensor) -> Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                             device=x.device)


def stft(x: Tensor, n_fft: int = 510, hop_length: int = 128,
         center: bool = True) -> Tensor:
    """(..., T) real -> (..., F, n_frames) complex64, F = n_fft//2 + 1."""
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]).float(), n_fft, hop_length, n_fft,
        _window(n_fft, x), center=center, pad_mode="constant",
        normalized=False, onesided=True, return_complex=True)
    return spec.reshape(lead + spec.shape[-2:])


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
