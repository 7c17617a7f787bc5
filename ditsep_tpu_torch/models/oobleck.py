"""OobleckVAE: the fully-convolutional audio autoencoder of the latent path
(port of ditsep_tpu/models/oobleck.py:43-427; reference: stable-audio-tools
models/autoencoders.py:59-356 and the VAE bottleneck,
models/bottleneck.py:57-86).

Layouts are NCW throughout: audio (B, C, T), latents (B, D, Tl); the convs
are ``F.conv1d`` / ``F.conv_transpose1d`` (cuDNN on the card).

Weight normalization is an explicit (g, v) pair, ``w = g * v / ||v||``
computed every call with 1e-12 under the square root, as the JAX package
does, in the reference's torch layouts: ``weight_v`` (out, in, k) and
``weight_g`` (out, 1, 1) for a conv, ``weight_v`` (in, out, k) and
``weight_g`` (in, 1, 1) for a transposed conv (the norm per *input*
channel). Modules are named after the reference's ``nn.Sequential``
layout (``encoder.layers.N...``, ``decoder.layers.N...``; an activation
with parameters is ``layers.N.act``), so a stable-audio-tools state_dict
loads with ``load_state_dict``.

``dtype`` is the compute dtype of the convs and activations, as the JAX
package's: parameters stay float32 (the weight is normalized in float32,
then cast). ``encode`` and ``decode`` return float32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch import parallel

Tensor = torch.Tensor
Padding = Union[int, Tuple[int, int], None]


def snake_beta(x: Tensor, alpha: Tensor, beta: Tensor) -> Tensor:
    """SnakeBeta x + 1/(e^beta + 1e-9) sin^2(e^alpha x) over the channel
    axis 1, with log-scale parameters (C,)."""
    a = torch.exp(alpha).to(x.dtype)[None, :, None]
    b = torch.exp(beta).to(x.dtype)[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.sin(a * x) ** 2


class SnakeBeta(nn.Module):
    """Learnable SnakeBeta activation (``alpha``, ``beta`` zero-init)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.zeros_(self.alpha)
        nn.init.zeros_(self.beta)

    def forward(self, x: Tensor) -> Tensor:
        return snake_beta(x, self.alpha, self.beta)


class Activation(nn.Module):
    """SnakeBeta (parameters under ``act``) or a parameter-free ELU."""

    def __init__(self, use_snake: bool, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels) if use_snake else nn.ELU()

    def forward(self, x: Tensor) -> Tensor:
        return self.act(x)


def _weight_norm(v: Tensor, g: Tensor, dtype: torch.dtype) -> Tensor:
    """g * v / sqrt(sum(v^2 over dims 1, 2) + 1e-12), in float32, cast."""
    v32 = v.float()
    norm = torch.sqrt((v32 ** 2).sum(dim=(1, 2), keepdim=True) + 1e-12)
    return (v32 / norm * g.float()).to(dtype)


class WNConv1d(nn.Module):
    """Weight-normalized Conv1d: ``padding`` an int (symmetric), a (left,
    right) pair, or None for dilation * (k - 1) // 2; ``groups`` as
    Conv1d's."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int = 1, dilation: int = 1, padding: Padding = None,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 groups: int = 1):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        if padding is None:
            padding = dilation * (kernel_size - 1) // 2
        self.padding = (padding if isinstance(padding, tuple)
                        else (padding, padding))
        self.compute_dtype = dtype
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                                 kernel_size))
        self.weight_g = nn.Parameter(torch.empty(out_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """v ~ U(+-1/sqrt(fan_in)), fan_in = in / groups * k (torch's Conv1d
        default and the JAX package's), g = ||v||, bias 0."""
        _init_wn(self.weight_v, self.weight_g, self.bias,
                 self.weight_v.shape[1] * self.weight_v.shape[2], generator)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype or x.dtype
        w = _weight_norm(self.weight_v, self.weight_g, dt)
        left, right = self.padding
        pad = left
        if left != right:
            x, pad = F.pad(x, (left, right)), 0
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv1d(x.to(dt), w, b, stride=self.stride, padding=pad,
                        dilation=self.dilation, groups=self.groups)


class WNConvTranspose1d(nn.Module):
    """Weight-normalized ConvTranspose1d: out = (T - 1) s - 2 p + k +
    ``output_padding``, which extends the right edge only (torch's, and the
    JAX package's)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int, padding: int, output_padding: int = 0,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.compute_dtype = dtype
        self.weight_v = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size))
        self.weight_g = nn.Parameter(torch.empty(in_ch, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """As WNConv1d's, with fan_in = out * k (torch's ConvTranspose
        quirk, kept by the JAX package), g per input channel."""
        _init_wn(self.weight_v, self.weight_g, self.bias,
                 self.weight_v.shape[1] * self.weight_v.shape[2], generator)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype or x.dtype
        w = _weight_norm(self.weight_v, self.weight_g, dt)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose1d(x.to(dt), w, b, stride=self.stride,
                                  padding=self.padding,
                                  output_padding=self.output_padding)


class NearestUpsampleConv(WNConv1d):
    """Nearest-neighbour upsampling by ``stride`` then a bias-free k = 2s
    conv padded (s - 1, s), as torch's padding='same' pads an even kernel:
    exactly T * s samples."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, *,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, 2 * stride,
                         padding=(stride - 1, stride), bias=False,
                         dtype=dtype)
        self.up = stride

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(torch.repeat_interleave(x, self.up, dim=-1))


def _init_wn(v: Tensor, g: Tensor, bias: Optional[Tensor], fan_in: int,
             generator: Optional[torch.Generator]) -> None:
    bound = math.sqrt(1.0 / fan_in)
    with torch.no_grad():
        v.uniform_(-bound, bound, generator=generator)
        g.copy_(torch.sqrt((v ** 2).sum(dim=(1, 2), keepdim=True)))
        if bias is not None:
            bias.zero_()


class ResidualUnit(nn.Module):
    """act -> dilated k=7 conv -> act -> k=1 conv, plus the input
    (``layers`` 0-3). ``flax_names``: the JAX package's child names (for
    ``models.weights.params_from_jax`` with a model)."""

    flax_names = {"act_0": "layers.0.act", "conv_0": "layers.1",
                  "act_1": "layers.2.act", "conv_1": "layers.3"}

    def __init__(self, channels: int, dilation: int, use_snake: bool,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.Sequential(
            Activation(use_snake, channels),
            WNConv1d(channels, channels, 7, dilation=dilation,
                     padding=dilation * 6 // 2, dtype=dtype),
            Activation(use_snake, channels),
            WNConv1d(channels, channels, 1, padding=0, dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x) + x


class EncoderBlock(nn.Module):
    """Residual units of dilation 1, 3, 9, act, strided k = 2s conv
    (``layers`` 0-4)."""

    flax_names = {"res_0": "layers.0", "res_1": "layers.1",
                  "res_2": "layers.2", "act": "layers.3.act",
                  "down": "layers.4"}

    def __init__(self, in_ch: int, out_ch: int, stride: int, use_snake: bool,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.Sequential(
            *(ResidualUnit(in_ch, d, use_snake, dtype) for d in (1, 3, 9)),
            Activation(use_snake, in_ch),
            WNConv1d(in_ch, out_ch, 2 * stride, stride=stride,
                     padding=math.ceil(stride / 2), dtype=dtype))

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)


class DecoderBlock(nn.Module):
    """act, upsampling by ``stride`` (transposed k = 2s conv, or nearest +
    conv), residual units of dilation 1, 3, 9 (``layers`` 0-4)."""

    flax_names = {"act": "layers.0.act", "up": "layers.1",
                  "res_0": "layers.2", "res_1": "layers.3",
                  "res_2": "layers.4"}

    def __init__(self, in_ch: int, out_ch: int, stride: int, use_snake: bool,
                 use_nearest_upsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        up = (NearestUpsampleConv(in_ch, out_ch, stride, dtype=dtype)
              if use_nearest_upsample else
              WNConvTranspose1d(in_ch, out_ch, 2 * stride, stride=stride,
                                padding=math.ceil(stride / 2), dtype=dtype))
        self.layers = nn.Sequential(
            Activation(use_snake, in_ch), up,
            *(ResidualUnit(out_ch, d, use_snake, dtype) for d in (1, 3, 9)))

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)


class OobleckEncoder(nn.Module):
    """(B, C_in, T) -> (B, latent_dim, T / hop): stem k=7 conv, one
    EncoderBlock a stride, act, head k=3 conv."""

    def __init__(self, in_channels: int = 1, channels: int = 128,
                 latent_dim: int = 128,
                 c_mults: Sequence[int] = (1, 2, 4, 8, 16),
                 strides: Sequence[int] = (2, 4, 4, 8, 8),
                 use_snake: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        cm = (1,) + tuple(c_mults)
        layers = [WNConv1d(in_channels, cm[0] * channels, 7, padding=3,
                           dtype=dtype)]
        for i, s in enumerate(strides):
            layers.append(EncoderBlock(cm[i] * channels, cm[i + 1] * channels,
                                       s, use_snake, dtype))
        layers += [Activation(use_snake, cm[-1] * channels),
                   WNConv1d(cm[-1] * channels, latent_dim, 3, padding=1,
                            dtype=dtype)]
        self.layers = nn.Sequential(*layers)
        n = len(strides)
        self.flax_names = {"stem": "layers.0", "act": f"layers.{n + 1}.act",
                           "head": f"layers.{n + 2}",
                           **{f"block_{i}": f"layers.{i + 1}"
                              for i in range(n)}}
        self.hop_length = math.prod(strides)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (SnakeBeta, WNConv1d, WNConvTranspose1d)):
                m.reset_parameters(generator)

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)


class OobleckDecoder(nn.Module):
    """(B, latent_dim, Tl) -> (B, C_out, Tl * hop): stem k=7 conv, one
    DecoderBlock a stride (deepest first), then, as the reference, the
    snake activation or none (unlike the encoder's ELU), a bias-free head
    k=7 conv and tanh."""

    def __init__(self, out_channels: int = 1, channels: int = 128,
                 latent_dim: int = 64,
                 c_mults: Sequence[int] = (1, 2, 4, 8, 16),
                 strides: Sequence[int] = (2, 4, 4, 8, 8),
                 use_snake: bool = False, use_nearest_upsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cm = (1,) + tuple(c_mults)
        layers = [WNConv1d(latent_dim, cm[-1] * channels, 7, padding=3,
                           dtype=dtype)]
        for i in range(len(strides), 0, -1):
            layers.append(DecoderBlock(
                cm[i] * channels, cm[i - 1] * channels, strides[i - 1],
                use_snake, use_nearest_upsample, dtype))
        layers += [Activation(True, cm[0] * channels) if use_snake
                   else nn.Identity(),
                   WNConv1d(cm[0] * channels, out_channels, 7, padding=3,
                            bias=False, dtype=dtype), nn.Tanh()]
        self.layers = nn.Sequential(*layers)

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)


def vae_sample(mean: Tensor, scale: Tensor,
               noise: Tensor) -> Tuple[Tensor, Tensor]:
    """Reparameterized posterior sample and KL of (B, D, Tl) moments with
    the standard-normal ``noise``: stdev = softplus(scale) + 1e-4; the KL
    sums over the latent channel axis (dim 1) and averages the rest."""
    stdev = F.softplus(scale) + 1e-4
    var = stdev * stdev
    latents = noise.to(mean.dtype) * stdev + mean
    kl = (mean * mean + var - torch.log(var) - 1.0).sum(dim=1).mean()
    return latents, kl


class OobleckVAE(nn.Module):
    """Encoder + VAE bottleneck + decoder. ``encoder`` outputs 2 x
    latent_dim channels (mean, scale)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 channels: int = 128, latent_dim: int = 64,
                 c_mults: Sequence[int] = (1, 2, 4, 8, 16),
                 strides: Sequence[int] = (2, 4, 4, 8, 8),
                 use_snake: bool = False, soft_clip: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.latent_dim, self.out_channels = latent_dim, out_channels
        self.strides = tuple(strides)
        self.soft_clip = soft_clip
        self.encoder = OobleckEncoder(in_channels, channels, 2 * latent_dim,
                                      c_mults, strides, use_snake, dtype)
        self.decoder = OobleckDecoder(out_channels, channels, latent_dim,
                                      c_mults, strides, use_snake,
                                      dtype=dtype)

    @property
    def downsampling_ratio(self) -> int:
        return math.prod(self.strides)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """(Re)initialise every parameter from ``generator``, in module
        order."""
        for m in self.modules():
            if isinstance(m, (SnakeBeta, WNConv1d, WNConvTranspose1d)):
                m.reset_parameters(generator)

    def moments(self, audio: Tensor) -> Tuple[Tensor, Tensor]:
        """(B, C, T) -> the posterior's (mean, scale), each (B, D, T/hop),
        float32."""
        h = self.encoder(audio).float()
        return h[:, :self.latent_dim], h[:, self.latent_dim:]

    def encode(self, audio: Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Tensor] = None, return_info: bool = False):
        """(B, C, T) -> (B, D, T/hop). A posterior sample when
        ``generator`` or an explicit standard-normal ``noise`` (B, D, Tl)
        is given, else the mode (the mean)."""
        mean, scale = self.moments(audio)
        if generator is None and noise is None:
            latents, kl = mean, torch.zeros((), device=mean.device)
        else:
            if noise is None:
                noise = parallel.draw_rows(lambda s: torch.randn(
                    s, generator=generator, device=mean.device), mean.shape)
            latents, kl = vae_sample(mean, scale, noise)
        if return_info:
            return latents, {"kl": kl, "mean": mean, "scale": scale}
        return latents

    def decode(self, latents: Tensor) -> Tensor:
        """(B, D, Tl) -> (B, C, Tl * hop), float32."""
        y = self.decoder(latents).float()
        return torch.tanh(y) if self.soft_clip else y


def _chunk_starts(total: int, size: int, hop: int) -> list:
    starts = list(range(0, total - size + 1, hop))
    if starts[-1] + size != total:
        starts.append(total - size)
    return starts


def _stitch(chunks: Tensor, starts: list, total: int, size: int,
            trim: int) -> Tensor:
    """Overlap-trim stitching of (B, n, C, size) chunks at ``starts`` (in
    output samples): each chunk but the first drops ``trim`` at its left,
    each but the last at its right; the last chunk ends at ``total``."""
    b, n, c, _ = chunks.shape
    out = chunks.new_zeros((b, c, total))
    for i in range(n):
        t_start = total - size if i == n - 1 else starts[i]
        t_end, c_start, c_end = t_start + size, 0, size
        if i > 0:
            t_start, c_start = t_start + trim, c_start + trim
        if i < n - 1:
            t_end, c_end = t_end - trim, c_end - trim
        out[:, :, t_start:t_end] = chunks[:, i, :, c_start:c_end]
    return out


def encode_audio_chunked(vae: OobleckVAE, audio: Tensor, *,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Tensor] = None, overlap: int = 32,
                         chunk_size: int = 128) -> Tensor:
    """Encode long (B, C, T) audio in chunks of ``chunk_size`` latent
    frames overlapping by ``overlap``, all chunks in one batch, stitched
    with ``overlap / 2`` frames trimmed at each inner edge (port of
    ditsep_tpu/models/oobleck.py:430-464; reference: autoencoders.py:
    596-664). ``generator`` / ``noise`` ((B * chunks, D, chunk_size))
    sample the posterior as ``OobleckVAE.encode``."""
    spl = vae.downsampling_ratio
    b, c, total = audio.shape
    cs, ov = chunk_size * spl, overlap * spl
    if total <= cs:
        return vae.encode(audio, generator=generator, noise=noise)
    starts = _chunk_starts(total, cs, cs - ov)
    flat = torch.stack([audio[:, :, s:s + cs] for s in starts],
                       dim=1).reshape(b * len(starts), c, cs)
    lat = vae.encode(flat, generator=generator, noise=noise)
    lat = lat.reshape(b, len(starts), vae.latent_dim, chunk_size)
    return _stitch(lat, [s // spl for s in starts], total // spl,
                   chunk_size, overlap // 2)


def decode_audio_chunked(vae: OobleckVAE, latents: Tensor, *,
                         overlap: int = 32, chunk_size: int = 128) -> Tensor:
    """Decode long (B, D, Tl) latents in chunks, the mirror of
    ``encode_audio_chunked`` (port of ditsep_tpu/models/oobleck.py:
    467-503)."""
    spl = vae.downsampling_ratio
    b, d, total = latents.shape
    if total <= chunk_size:
        return vae.decode(latents)
    starts = _chunk_starts(total, chunk_size, chunk_size - overlap)
    flat = torch.stack([latents[:, :, s:s + chunk_size] for s in starts],
                       dim=1).reshape(b * len(starts), d, chunk_size)
    dec = vae.decode(flat).reshape(b, len(starts), vae.out_channels,
                                   chunk_size * spl)
    return _stitch(dec, [s * spl for s in starts], total * spl,
                   chunk_size * spl, (overlap // 2) * spl)
