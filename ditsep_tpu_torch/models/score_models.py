"""STFT-domain score model around the NCSN++ backbone.

Port of ditsep_tpu/models/score_models.py:ScoreModelNCSNpp. The public API
takes channel-first waveforms (B, C, T) as the JAX package does; the
backbone runs on a logical NCHW spectrogram (B, 2C, F, frames), the
layout of the original torch DiTSep.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.ncsnpp import NCSNpp
from ditsep_tpu_torch.ops.stft import istft, n_frames_prepadded, stft

Tensor = torch.Tensor


def _mag_rescale(spec: Tensor, new_mag_over_mag) -> Tensor:
    """Rescale a complex spectrogram's magnitude, keeping its phase, as
    ``s * f(|s|)/|s|``; the ratio is guarded to 0 where ``|s| = 0``."""
    mag = spec.abs()
    ratio = new_mag_over_mag(mag.clamp(min=1e-20))
    return spec * torch.where(mag > 0, ratio, torch.zeros_like(ratio))


def _spec_transform_forward(spec: Tensor, transform: str, exponent: float,
                            factor: float) -> Tensor:
    """Magnitude compression. Quirk kept from the reference: 'exponent'
    multiplies by the SIGNED factor here but divides by abs(factor) in the
    backward transform."""
    if transform == "exponent":
        if exponent != 1.0:
            e = abs(exponent)
            spec = _mag_rescale(spec, lambda m: m ** (e - 1.0))
        return spec * factor
    if transform == "log":
        spec = _mag_rescale(spec, lambda m: torch.log1p(m) / m)
        return spec * abs(factor)
    if transform == "none":
        return spec
    raise ValueError("transform must be one of 'exponent'|'log'|'none'")


def _spec_transform_backward(spec: Tensor, transform: str, exponent: float,
                             factor: float) -> Tensor:
    """Inverse of :func:`_spec_transform_forward`."""
    if transform == "exponent":
        spec = spec / abs(factor)
        if exponent != 1.0:
            e = abs(exponent)
            spec = _mag_rescale(spec, lambda m: m ** (1.0 / e - 1.0))
        return spec
    if transform == "log":
        spec = spec / abs(factor)
        return _mag_rescale(spec, lambda m: (torch.exp(m) - 1.0) / m)
    if transform == "none":
        return spec
    raise ValueError("transform must be one of 'exponent'|'log'|'none'")


class ScoreModelNCSNpp(nn.Module):
    """forward(xt, time_cond, mix): concat channels -> pad n_fft-hop ->
    STFT -> magnitude compression -> re/im channels -> pad frames %64 ->
    NCSN++ -> inverse of each step -> iSTFT.

    ``mask_padding`` (masked scoring, an extension beyond the reference):
    the frames past each item's own STFT coverage -- the %64 frame pad,
    and with ``lengths`` each item's padded tail -- are masked out of
    every GroupNorm statistic and attention row, so that padding does not
    change the scores on the valid region. Off, the reference
    semantics."""

    def __init__(
        self,
        num_sources: int = 2,
        n_fft: int = 510,
        hop_length: int = 128,
        transform: str = "exponent",
        spec_abs_exponent: float = 0.5,
        spec_factor: float = 0.15,
        nf: int = 64,
        ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 2, 2, 2),
        num_res_blocks: int = 2,
        attn_resolutions: Tuple[int, ...] = (16,),
        resamp_with_conv: bool = True,
        image_size: int = 256,
        centered: bool = False,
        dropout: float = 0.0,
        fir: bool = True,
        mask_padding: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.mask_padding = mask_padding
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.transform = transform
        self.spec_abs_exponent = spec_abs_exponent
        self.spec_factor = spec_factor
        self.backbone = NCSNpp(
            nf=nf, ch_mult=tuple(ch_mult), num_res_blocks=num_res_blocks,
            attn_resolutions=tuple(attn_resolutions),
            resamp_with_conv=resamp_with_conv, image_size=image_size,
            centered=centered, dropout=dropout, fir=fir,
            num_channels_in=2 * num_sources + 2,
            num_channels_out=2 * num_sources, dtype=dtype)

    def pre_process(self, x: Tensor) -> Tuple[Tensor, int, int]:
        """(B, C, T) waveform -> (B, 2C, F, frames) real NCHW spectrogram.
        Returns (spec, n_samples, frame_pad)."""
        n_samples = x.shape[-1]
        x = F.pad(x, (0, self.n_fft - self.hop_length))
        spec = stft(x, self.n_fft, self.hop_length)  # (B, C, F, frames)
        spec = _spec_transform_forward(
            spec, self.transform, self.spec_abs_exponent, self.spec_factor)
        h = torch.cat([spec.real, spec.imag], dim=1)
        rem = h.shape[-1] % 64
        n_pad = 0 if rem == 0 else 64 - rem
        if n_pad:
            h = F.pad(h, (0, n_pad))
        return h.contiguous(), n_samples, n_pad

    def post_process(self, h: Tensor, n_samples: int, n_pad: int) -> Tensor:
        """(B, 2C, F, frames) -> (B, C, T) float32 waveform."""
        h = h.float()  # the spectral inverse runs in f32 (complex64)
        if n_pad:
            h = h[..., :-n_pad]
        c = h.shape[1] // 2
        spec = torch.complex(h[:, :c], h[:, c:])
        spec = _spec_transform_backward(
            spec, self.transform, self.spec_abs_exponent, self.spec_factor)
        return istft(spec, self.n_fft, self.hop_length, length=n_samples)

    def time_mask(self, h: Tensor, n_pad: int,
                  lengths: Optional[Tensor] = None) -> Tensor:
        """(B, frames) validity of the spectrogram ``h``'s frames: all but
        the %64 frame pad, or with ``lengths`` (B,) the frames that each
        item's valid samples cover."""
        n_frames = h.shape[-1]
        t_idx = torch.arange(n_frames, device=h.device)
        if lengths is None:
            return (t_idx < n_frames - n_pad).expand(h.shape[0], n_frames)
        valid = n_frames_prepadded(lengths.to(h.device), self.n_fft,
                                   self.hop_length)
        return t_idx[None, :] < valid[:, None]

    def forward(self, xt: Tensor, time_cond: Tensor, mix: Tensor, *,
                lengths: Optional[Tensor] = None) -> Tensor:
        """xt (B, n_src, T), time_cond (B,), mix (B, 1, T) -> (B, n_src, T).

        ``lengths`` (B,) integer: each item's valid sample count, read
        only with ``mask_padding``."""
        h, n_samples, n_pad = self.pre_process(torch.cat([xt, mix], dim=1))
        time_mask = (self.time_mask(h, n_pad, lengths) if self.mask_padding
                     else None)
        h = self.backbone(h, time_cond, time_mask=time_mask)
        return self.post_process(h, n_samples, n_pad)


class LatentScoreModelNCSNpp(nn.Module):
    """The latent-domain score network (port of ditsep_tpu/models/
    score_models.py:191-244): forward(xt (B, n_src, D, Tl), time_cond,
    mix (B, 1, D, Tl)) concatenates the channels, zero-pads Tl on the
    right to a multiple of ``max_latent_length``, runs NCSN++ on (B,
    n_src + 1, D, Tl) with the latent dimension D as its height, and crops
    the pad. Returns float32.

    ``mask_padding``: the padded frames are masked out of every GroupNorm
    and attention statistic; with ``lengths`` (B,), each item's count of
    valid latent frames, each item's tail too."""

    def __init__(
        self,
        num_sources: int = 2,
        max_latent_length: int = 4,
        nf: int = 128,
        ch_mult: Tuple[int, ...] = (1, 2, 2),
        num_res_blocks: int = 2,
        attn_resolutions: Tuple[int, ...] = (16,),
        resamp_with_conv: bool = True,
        image_size: int = 64,
        centered: bool = True,
        dropout: float = 0.0,
        mask_padding: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.max_latent_length = max_latent_length
        self.mask_padding = mask_padding
        self.backbone = NCSNpp(
            nf=nf, ch_mult=tuple(ch_mult), num_res_blocks=num_res_blocks,
            attn_resolutions=tuple(attn_resolutions),
            resamp_with_conv=resamp_with_conv, image_size=image_size,
            centered=centered, dropout=dropout,
            num_channels_in=num_sources + 1, num_channels_out=num_sources,
            dtype=dtype)

    def forward(self, xt: Tensor, time_cond: Tensor, mix: Tensor, *,
                lengths: Optional[Tensor] = None) -> Tensor:
        x = torch.cat([xt, mix], dim=1)
        n_t = x.shape[-1]
        n_pad = -n_t % self.max_latent_length
        if n_pad:
            x = F.pad(x, (0, n_pad))
        time_mask = None
        if self.mask_padding:
            t_idx = torch.arange(n_t + n_pad, device=x.device)
            if lengths is None:
                time_mask = (t_idx < n_t).expand(x.shape[0], n_t + n_pad)
            else:
                time_mask = t_idx[None, :] < lengths.to(x.device)[:, None]
        h = self.backbone(x, time_cond, time_mask=time_mask).float()
        return h[..., :n_t] if n_pad else h
