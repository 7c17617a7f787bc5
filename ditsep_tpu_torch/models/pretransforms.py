"""Pretransforms: invertible encodings applied before diffusion (port of
ditsep_tpu/models/pretransforms.py; reference: stable-audio-tools
models/pretransforms.py:5-275): a frozen autoencoder (``chunked`` through
the long-audio codec), a Haar wavelet cascade, time-to-channel patching
and a PQMF filter bank. Each has ``encode`` / ``decode`` on (B, C, T),
``downsampling_ratio`` and ``encoded_channels``.

``DACPretransform`` composes the port's DAC encoder and decoder
(models/codecs.py) with ``DACResidualVQ``: the pretrained descript codec's
architecture, its weights seeded (no DAC checkpoint is in the repository);
``tokenize`` / ``decode_tokens`` carry the token LM's discrete codes.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.oobleck import (
    OobleckVAE, decode_audio_chunked, encode_audio_chunked,
)

Tensor = torch.Tensor


class AutoencoderPretransform(nn.Module):
    """A frozen OobleckVAE (its parameters take no gradient): ``encode``
    gives the posterior mean (a sample with ``generator`` or ``noise``)
    over ``scale``, ``decode`` multiplies by ``scale`` first."""

    def __init__(self, model: OobleckVAE, scale: float = 1.0,
                 chunked: bool = False):
        super().__init__()
        self.model = model.requires_grad_(False)
        self.scale, self.chunked = scale, chunked

    @property
    def downsampling_ratio(self) -> int:
        return self.model.downsampling_ratio

    @property
    def encoded_channels(self) -> int:
        return self.model.latent_dim

    @property
    def io_channels(self) -> int:
        return self.model.encoder.layers[0].weight_v.shape[1]

    def encode(self, x: Tensor, generator: Optional[torch.Generator] = None,
               noise: Optional[Tensor] = None) -> Tensor:
        if self.chunked:
            enc = encode_audio_chunked(self.model, x, generator=generator,
                                       noise=noise)
        else:
            enc = self.model.encode(x, generator=generator, noise=noise)
        return enc / self.scale

    def decode(self, z: Tensor) -> Tensor:
        z = z * self.scale
        if self.chunked:
            return decode_audio_chunked(self.model, z)
        return self.model.decode(z)


class WaveletPretransform(nn.Module):
    """``levels`` Haar levels: each halves time and doubles channels;
    perfect reconstruction."""

    def __init__(self, channels: int = 1, levels: int = 4,
                 wavelet: str = "haar"):
        super().__init__()
        if wavelet != "haar":
            raise NotImplementedError("only the haar wavelet is built in")
        self.channels, self.levels = channels, levels

    @property
    def downsampling_ratio(self) -> int:
        return 2 ** self.levels

    @property
    def encoded_channels(self) -> int:
        return self.channels * self.downsampling_ratio

    @property
    def io_channels(self) -> int:
        return self.channels

    def encode(self, x: Tensor) -> Tensor:
        """(B, C, T) -> (B, C * 2^L, T / 2^L)."""
        for _ in range(self.levels):
            b, c, t = x.shape
            pairs = x.reshape(b, c, t // 2, 2)
            lo = (pairs[..., 0] + pairs[..., 1]) / math.sqrt(2.0)
            hi = (pairs[..., 0] - pairs[..., 1]) / math.sqrt(2.0)
            x = torch.cat([lo, hi], dim=1)
        return x

    def decode(self, z: Tensor) -> Tensor:
        for _ in range(self.levels):
            b, c, t = z.shape
            lo, hi = z.chunk(2, dim=1)
            even = (lo + hi) / math.sqrt(2.0)
            odd = (lo - hi) / math.sqrt(2.0)
            z = torch.stack([even, odd], dim=-1).reshape(b, c // 2, t * 2)
        return z


class PatchedPretransform(nn.Module):
    """Time-to-channel patching by ``patch_size``."""

    def __init__(self, channels: int = 1, patch_size: int = 4):
        super().__init__()
        self.channels, self.patch_size = channels, patch_size

    @property
    def downsampling_ratio(self) -> int:
        return self.patch_size

    @property
    def encoded_channels(self) -> int:
        return self.channels * self.patch_size

    @property
    def io_channels(self) -> int:
        return self.channels

    def encode(self, x: Tensor) -> Tensor:
        b, c, t = x.shape
        p = self.patch_size
        return x.reshape(b, c, t // p, p).transpose(2, 3).reshape(
            b, c * p, t // p)

    def decode(self, z: Tensor) -> Tensor:
        b, cp, t = z.shape
        p = self.patch_size
        return z.reshape(b, cp // p, p, t).transpose(2, 3).reshape(
            b, cp // p, t * p)


class PQMFPretransform(nn.Module):
    """Pseudo-QMF bank of ``bands`` bands: a Kaiser-windowed prototype
    lowpass of ``taps`` taps cosine-modulated into analysis filters;
    synthesis upsamples each band and filters with the same taps (gain
    M)."""

    def __init__(self, bands: int = 8, taps: int = 64, beta: float = 9.0):
        super().__init__()
        self.bands, self.taps, self.beta = bands, taps, beta

    def _filters(self) -> np.ndarray:
        n, m = self.taps, self.bands
        k = np.arange(n) - (n - 1) / 2
        cutoff = 1.0 / (2.0 * m)
        h = 2 * cutoff * np.sinc(2 * cutoff * k) * np.kaiser(n, self.beta)
        h = (h / np.sum(h)).astype(np.float32)
        filts = np.zeros((m, n), np.float32)
        for b in range(m):
            phase = (-1) ** b * math.pi / 4
            filts[b] = 2 * h * np.cos((2 * b + 1) * math.pi / (2 * m)
                                      * (np.arange(n) - (n - 1) / 2) + phase)
        return filts

    @property
    def downsampling_ratio(self) -> int:
        return self.bands

    def encode(self, x: Tensor) -> Tensor:
        """(B, C, T) -> (B, C * M, T / M): a true convolution with each
        filter, stride M."""
        filts = torch.from_numpy(self._filters()).to(x)
        b, c, t = x.shape
        pad = self.taps // 2
        flat = F.pad(x.reshape(b * c, 1, t),
                     (pad, pad - 1 + self.taps % 2))
        y = F.conv1d(flat, filts.flip(-1)[:, None, :], stride=self.bands)
        return y.reshape(b, c * self.bands, -1)

    def decode(self, z: Tensor) -> Tensor:
        """(B, C * M, T / M) -> (B, C, T): zero-stuffed by M, filtered,
        summed over the bands."""
        filts = torch.from_numpy(self._filters()).to(z)
        m = self.bands
        b, cm, tm = z.shape
        c = cm // m
        up = z.new_zeros((b * c, m, (tm - 1) * m + 1))
        up[:, :, ::m] = z.reshape(b * c, m, tm)
        pad = self.taps // 2
        up = F.pad(up, (pad - 1 + self.taps % 2, pad))
        y = F.conv1d(up, (filts * m)[None])
        return y.reshape(b, c, -1)


class DACPretransform(nn.Module):
    """The DAC pretransform: ``encoder`` (a ``DACEncoderWrapper``),
    ``decoder`` (a ``DACDecoderWrapper``) and ``quantizer`` (a
    ``DACResidualVQ``), frozen unless ``enable_grad``. Audio (B, C, T),
    latents (B, D, Tl), codes (B, Q, Tl)."""

    is_discrete = True

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 quantizer: nn.Module, scale: float = 1.0,
                 quantize_on_decode: bool = True, enable_grad: bool = False,
                 io_channels: int = 1):
        super().__init__()
        self.encoder, self.decoder, self.quantizer = (encoder, decoder,
                                                      quantizer)
        self.scale, self.quantize_on_decode = scale, quantize_on_decode
        self.io_channels = io_channels
        self.requires_grad_(enable_grad)

    @property
    def downsampling_ratio(self) -> int:
        return self.encoder.hop_length

    @property
    def encoded_channels(self) -> int:
        if self.encoder.latent_dim is not None:
            return self.encoder.latent_dim
        return self.encoder.d_model * 2 ** len(self.encoder.strides)

    @property
    def num_quantizers(self) -> int:
        return self.quantizer.n_codebooks

    @property
    def codebook_size(self) -> int:
        return self.quantizer.codebook_size

    def _quantize(self, lat: Tensor) -> Tensor:
        return self.quantizer(lat.transpose(1, 2))[0].transpose(1, 2)

    def encode(self, x: Tensor) -> Tensor:
        """(B, C, T) -> (B, D, Tl) over ``scale``; quantized here unless
        ``quantize_on_decode``."""
        lat = self.encoder(x)
        if not self.quantize_on_decode:
            lat = self._quantize(lat)
        return lat / self.scale

    def decode(self, z: Tensor) -> Tensor:
        """(B, D, Tl) -> (B, C, T)."""
        lat = z * self.scale
        if self.quantize_on_decode:
            lat = self._quantize(lat)
        return self.decoder(lat)

    def tokenize(self, x: Tensor) -> Tensor:
        """(B, C, T) -> integer codes (B, Q, Tl)."""
        return self.quantizer(self.encoder(x).transpose(1, 2))[1].transpose(
            1, 2)

    def decode_tokens(self, tokens: Tensor) -> Tensor:
        """Codes (B, Q, Tl) -> audio (B, C, T)."""
        lat = self.quantizer.from_codes(tokens.transpose(1, 2))
        return self.decoder(lat.transpose(1, 2))
