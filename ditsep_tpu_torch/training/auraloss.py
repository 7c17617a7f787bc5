"""Spectral losses: the STFT and multi-resolution STFT losses with the
perceptual A-weighting prefilter, and the PIT wrapper (port of
ditsep_tpu/training/auraloss.py; reference: the vendored
auraloss subset, src/stable_audio_tools/training/losses/auraloss.py and
losses/losses.py:111-154).

The STFT is ``ops.stft`` (``torch.stft``, the periodic Hann, zero padding
at center); every loss takes (B, C, T) waveforms and returns a scalar.
The log-mel and stereo sum-and-difference losses (JAX :144-190) complete
the set.
"""
from __future__ import annotations

import functools
import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.ops.stft import stft as stft_fn

Tensor = torch.Tensor


@functools.lru_cache(maxsize=8)
def a_weighting_fir(fs: int, ntaps: int = 101) -> np.ndarray:
    """Least-squares FIR fit of the IEC 1672 A-weighting response, float32
    taps (scipy's bilinear transform, freqz and firls, as the JAX
    package's)."""
    import scipy.signal

    f1, f2, f3, f4 = 20.598997, 107.65265, 737.86223, 12194.217
    a1000 = 1.9997
    nums = [(2 * np.pi * f4) ** 2 * (10 ** (a1000 / 20)), 0, 0, 0, 0]
    dens = np.polymul(
        [1, 4 * np.pi * f4, (2 * np.pi * f4) ** 2],
        [1, 4 * np.pi * f1, (2 * np.pi * f1) ** 2])
    dens = np.polymul(np.polymul(dens, [1, 2 * np.pi * f3]),
                      [1, 2 * np.pi * f2])
    b, a = scipy.signal.bilinear(nums, dens, fs=fs)
    w_iir, h_iir = scipy.signal.freqz(b, a, worN=512, fs=fs)
    taps = scipy.signal.firls(ntaps, w_iir, abs(h_iir), fs=fs)
    return taps.astype(np.float32)


def fir_prefilter(x: Tensor, taps: np.ndarray) -> Tensor:
    """Convolve the last axis with ``taps`` (a true convolution: the taps
    reversed under ``F.conv1d``'s correlation), 'same' padding k // 2; the
    leading axes fold into the batch.

    The convolution runs in float64 and rounds once to ``x``'s dtype: the
    A-weighting leaves the low bins of its output tiny, and the log
    magnitude's 1/|X| turns the accumulation's round-off there (and the
    10-bit mantissa of TF32, on by default for convs on the card) into
    gradient error. The perceptual MRSTFT's float32 gradient lies 6.5e-4
    to 1.7e-3 of its max off float64 so, 9.1e-4 to 2.0e-3 with a float32
    convolution (tests/test_torch_auraloss.py run as a script)."""
    k = len(taps)
    w = torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                        dtype=torch.float64, device=x.device).view(1, 1, k)
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]).double(), w, padding=k // 2)
    return y.to(x.dtype).reshape(x.shape[:-1] + y.shape[-1:])


def _magnitude(x: Tensor, fft_size: int, hop_size: int,
               eps: float = 1e-8) -> Tensor:
    """|STFT| as sqrt(clip(power, eps)), window length = fft_size."""
    spec = stft_fn(x, n_fft=fft_size, hop_length=hop_size)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(torch.clamp(power, min=eps))


def stft_loss(x: Tensor, y: Tensor, *, fft_size: int = 1024,
              hop_size: int = 256, w_sc: float = 1.0, w_log_mag: float = 1.0,
              w_lin_mag: float = 0.0, sample_rate: Optional[int] = None,
              perceptual_weighting: bool = False,
              scale_invariance: bool = False, eps: float = 1e-8) -> Tensor:
    """Single-resolution STFT loss of the estimate ``x`` against the
    target ``y``: spectral convergence (the norm per (B, C) item, then
    averaged; not auraloss's batch norm) + log-magnitude L1 (+ linear
    magnitude L1)."""
    if perceptual_weighting:
        assert sample_rate is not None
        taps = a_weighting_fir(sample_rate)
        x = fir_prefilter(x, taps)
        y = fir_prefilter(y, taps)
    x_mag = _magnitude(x, fft_size, hop_size, eps)
    y_mag = _magnitude(y, fft_size, hop_size, eps)
    if scale_invariance:
        alpha = ((x_mag * y_mag).sum(dim=(-2, -1), keepdim=True)
                 / torch.clamp((y_mag ** 2).sum(dim=(-2, -1), keepdim=True),
                               min=eps))
        y_mag = y_mag * alpha
    loss = 0.0
    if w_sc:
        num = torch.linalg.vector_norm((y_mag - x_mag).flatten(-2), dim=-1)
        den = torch.linalg.vector_norm(y_mag.flatten(-2), dim=-1)
        loss = loss + w_sc * (num / torch.clamp(den, min=eps)).mean()
    if w_log_mag:
        loss = loss + w_log_mag * (
            torch.log(torch.clamp(x_mag, min=eps))
            - torch.log(torch.clamp(y_mag, min=eps))).abs().mean()
    if w_lin_mag:
        loss = loss + w_lin_mag * (x_mag - y_mag).abs().mean()
    return loss


def multi_resolution_stft_loss(
        x: Tensor, y: Tensor, *,
        fft_sizes: Sequence[int] = (2048, 1024, 512, 256, 128, 64, 32),
        hop_sizes: Sequence[int] = (512, 256, 128, 64, 32, 16, 8),
        sample_rate: Optional[int] = None, perceptual_weighting: bool = False,
        w_sc: float = 1.0, w_log_mag: float = 1.0,
        w_lin_mag: float = 0.0) -> Tensor:
    """Mean of the per-resolution STFT losses; the prefilter runs once,
    before every resolution, and only with a ``sample_rate`` (defaults: the
    oobleck_finetune 'mrstft' config)."""
    assert len(fft_sizes) == len(hop_sizes)
    if perceptual_weighting and sample_rate is not None:
        taps = a_weighting_fir(sample_rate)
        x = fir_prefilter(x, taps)
        y = fir_prefilter(y, taps)
    total = 0.0
    for n_fft, hop in zip(fft_sizes, hop_sizes):
        total = total + stft_loss(x, y, fft_size=n_fft, hop_size=hop,
                                  w_sc=w_sc, w_log_mag=w_log_mag,
                                  w_lin_mag=w_lin_mag)
    return total / len(fft_sizes)


def pit_min(loss_fn: Callable[[Tensor, Tensor], Tensor], est: Tensor,
            ref: Tensor) -> Tensor:
    """``loss_fn(est[:, p], ref)`` for every source permutation p, then the
    minimum: of the batch-aggregated loss, as the reference's PITLoss.

    The minimum couples the batch: in a rank's shard of a global batch
    (``parallel.sharded``) the permutation is the one of least global
    loss (each permutation's loss averaged over the ranks), and the
    shard's own loss under it is returned, so that the ranks' gradients
    average to the global batch's."""
    n = est.shape[1]
    losses = torch.stack([loss_fn(est[:, list(p)], ref)
                          for p in itertools.permutations(range(n))])
    shard = parallel.couples_batch("pit_min")
    if shard is None:
        return losses.min()
    total = parallel.all_reduce_mean_(losses.detach().clone(), shard.mesh)
    return losses[torch.argmin(total)]


@functools.lru_cache(maxsize=8)
def mel_filterbank(fs: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Triangular mel filterbank (n_mels, n_fft // 2 + 1), float32, on the
    HTK mel scale with bins floor((n_fft + 1) f / fs), as the JAX
    package's."""
    fmax = fmax or fs / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mels) / fs).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        lo, ce, hi = bins[i], bins[i + 1], bins[i + 2]
        if ce > lo:
            fb[i, lo:ce] = (np.arange(lo, ce) - lo) / (ce - lo)
        if hi > ce:
            fb[i, ce:hi] = (hi - np.arange(ce, hi)) / (hi - ce)
    return fb


def mel_stft_loss(x: Tensor, y: Tensor, *, sample_rate: int = 8000,
                  fft_size: int = 1024, hop_size: int = 256,
                  n_mels: int = 80, eps: float = 1e-5) -> Tensor:
    """L1 distance of the log mel power spectrograms (reference:
    losses/losses.py MelSpectrogramLoss, auraloss MelSTFTLoss)."""
    fb = torch.from_numpy(mel_filterbank(sample_rate, fft_size, n_mels)).to(
        x.device, x.dtype)
    mel_x = torch.einsum("mf,...ft->...mt", fb,
                         _magnitude(x, fft_size, hop_size) ** 2)
    mel_y = torch.einsum("mf,...ft->...mt", fb,
                         _magnitude(y, fft_size, hop_size) ** 2)
    return (torch.log(mel_x + eps) - torch.log(mel_y + eps)).abs().mean()


def sum_and_difference_stft_loss(x: Tensor, y: Tensor, **kwargs) -> Tensor:
    """The stereo sum / difference MRSTFT (reference: auraloss.py
    SumAndDifferenceSTFTLoss): the mean of the MRSTFT of L + R and of
    L - R; ``kwargs`` go to ``multi_resolution_stft_loss``. x, y:
    (B, 2, T)."""
    if x.shape[1] != 2:
        raise ValueError(f"the sum / difference loss needs stereo input, "
                         f"got {x.shape[1]} channels")
    xs = (x[:, :1] + x[:, 1:], x[:, :1] - x[:, 1:])
    ys = (y[:, :1] + y[:, 1:], y[:, :1] - y[:, 1:])
    return 0.5 * (multi_resolution_stft_loss(xs[0], ys[0], **kwargs)
                  + multi_resolution_stft_loss(xs[1], ys[1], **kwargs))


def l1_loss(x: Tensor, y: Tensor) -> Tensor:
    return (x - y).abs().mean()


def mse_loss(x: Tensor, y: Tensor) -> Tensor:
    return ((x - y) ** 2).mean()
