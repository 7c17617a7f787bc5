"""DiffusionAttnUnet1D, the dance-diffusion v-objective U-Net (port of
ditsep_tpu/models/dau1d.py; reference: stable-audio-tools
models/diffusion.py:391-505, models/blocks.py:14-166).

Layout NCW. The reference's SkipBlock nesting is the recursive
``_DAULevel`` (``inner``), as in the JAX package, and its parameters carry
the JAX package's names (``stem{0,1,2}``, ``inner``, ``pre{0,1,2}``,
``attn{0..5}``, ``post{0,1,2}``, ``head{0,1,2}``, ``down``, ``up``,
``timestep_embed``), so ``models.weights.params_from_jax`` carries a JAX
tree over.

The FIR resamplers (``_fir_downsample`` / ``_fir_upsample``) are depthwise
1-D convs with reflect padding, ``F.conv1d`` / ``F.conv_transpose1d``; the
JAX package computes them with ``lax.conv_general_dilated``. The cond
input is resampled to the audio length as ``jax.image.resize(...,
"linear")`` does, antialiased when it shrinks (``linear_resize``).
``use_snake`` reproduces the JAX package's parameter names
(``snake_a_{width}``) and so its refusal of a block whose two activations
share a width.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.layers import GroupNorm
from ditsep_tpu_torch.models.transformer import Conv1d, Seeded

Tensor = torch.Tensor

# the reference's FIR kernels (blocks.py:99-110)
_KERNELS = {
    "linear": [1 / 8, 3 / 8, 3 / 8, 1 / 8],
    "cubic": [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
              0.43359375, 0.11328125, -0.03515625, -0.01171875],
    "lanczos3": [0.003689131001010537, 0.015056144446134567,
                 -0.03399861603975296, -0.066637322306633,
                 0.13550527393817902, 0.44638532400131226,
                 0.44638532400131226, 0.13550527393817902,
                 -0.066637322306633, -0.03399861603975296,
                 0.015056144446134567, 0.003689131001010537],
}


def fourier_features(x: Tensor, weight: Tensor) -> Tensor:
    """(B, F_in) with weight (F_out / 2, F_in) -> (B, F_out): cos and sin
    of 2 pi x W^T."""
    f = 2 * math.pi * x @ weight.T
    return torch.cat([f.cos(), f.sin()], dim=-1)


def _fir(x: Tensor, kernel: str, scale: float) -> Tensor:
    k = torch.tensor(_KERNELS[kernel], dtype=x.dtype, device=x.device) * scale
    return k.expand(x.shape[1], 1, k.shape[0])


def _fir_downsample(x: Tensor, kernel: str = "cubic") -> Tensor:
    """Depthwise FIR stride-2 downsampling of (B, C, T), reflect-padded
    by K / 2 - 1 a side."""
    w = _fir(x, kernel, 1.0)
    pad = w.shape[-1] // 2 - 1
    return F.conv1d(F.pad(x, (pad, pad), mode="reflect"), w, stride=2,
                    groups=x.shape[1])


def _fir_upsample(x: Tensor, kernel: str = "cubic") -> Tensor:
    """Depthwise FIR 2x upsampling of (B, C, T): reflect-padded by (K / 2)
    / 2 a side, a transposed conv of stride 2 with the kernel x 2."""
    w = _fir(x, kernel, 2.0)
    pad = (w.shape[-1] // 2 - 1 + 1) // 2
    return F.conv_transpose1d(F.pad(x, (pad, pad), mode="reflect"), w,
                              stride=2, padding=w.shape[-1] - 1,
                              groups=x.shape[1])


def linear_resize(x: Tensor, length: int) -> Tensor:
    """(B, C, T) -> (B, C, length) as ``jax.image.resize(..., "linear")``
    along time: a (T, length) triangle-kernel weight matrix (half-pixel
    centres), the kernel widened by T / length when shrinking (JAX's
    antialiasing), each column normalised by its sum."""
    t_in = x.shape[-1]
    if t_in == length:
        return x
    scale = length / t_in
    inv = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample_f = ((torch.arange(length, dtype=torch.float32) + 0.5) * inv
                - 0.5)
    w = torch.clamp(1.0 - (sample_f[None, :] - torch.arange(
        t_in, dtype=torch.float32)[:, None]).abs() / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= t_in - 0.5)
    w = torch.where(inside[None, :], w, 0.0)
    return torch.einsum("bct,tl->bcl", x, w.to(x))


class ConvTranspose1dSame(Conv1d):
    """flax's ``nn.ConvTranspose(padding="SAME")`` (no kernel flip): the
    input dilated by the stride, padded as ``lax.conv_transpose`` pads
    'SAME', then a plain conv; T -> T x stride. The weight (out, in, k),
    flax's (k, in, out) kernel transposed."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int, dtype: Optional[torch.dtype] = None):
        k, s = kernel_size, stride
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
        super().__init__(in_ch, out_ch, k, padding=(pad_a, pad_len - pad_a),
                         dtype=dtype)
        self.up = s

    def forward(self, x: Tensor) -> Tensor:
        b, c, t = x.shape
        dilated = x.new_zeros((b, c, (t - 1) * self.up + 1))
        dilated[..., ::self.up] = x
        return super().forward(dilated)


class ResConvBlock(nn.Module):
    """conv -> GroupNorm(1) -> GELU (exact) twice (the last block without
    the second norm and activation), plus the input through a bias-free
    1x1 ``skip`` where the width changes. ``use_snake``: the activation is
    h + sin^2(a h) / a with ``snake_a_{width}`` (ones)."""

    def __init__(self, c_in: int, c_mid: int, c_out: int,
                 is_last: bool = False, kernel_size: int = 5,
                 conv_bias: bool = True, use_snake: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if use_snake and not is_last and c_mid == c_out:
            # flax creates snake_a_{width} once a width: the JAX block
            # fails with NameInUseError here
            raise ValueError(f"use_snake needs the two activations' widths "
                             f"to differ (both {c_mid}), as in the JAX "
                             "package, whose parameter names collide")
        self.is_last, self.use_snake = is_last, use_snake
        pad = (kernel_size // 2, kernel_size // 2)
        self.conv1 = Conv1d(c_in, c_mid, kernel_size, padding=pad,
                            bias=conv_bias, dtype=dtype)
        self.norm1 = GroupNorm(1, c_mid, 1e-5, dtype)
        self.conv2 = Conv1d(c_mid, c_out, kernel_size, padding=pad,
                            bias=conv_bias, dtype=dtype)
        if not is_last:
            self.norm2 = GroupNorm(1, c_out, 1e-5, dtype)
        if c_in != c_out:
            self.skip = Conv1d(c_in, c_out, 1, bias=False, dtype=dtype)
        if use_snake:
            for c in {c_mid} | (set() if is_last else {c_out}):
                self.register_parameter(f"snake_a_{c}",
                                        nn.Parameter(torch.ones(c)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                p.fill_(1.0)

    def _act(self, h: Tensor) -> Tensor:
        if not self.use_snake:
            return F.gelu(h)
        a = getattr(self, f"snake_a_{h.shape[1]}").to(h.dtype)[:, None]
        return h + torch.sin(a * h) ** 2 / a.clamp_min(1e-9)

    def forward(self, x: Tensor) -> Tensor:
        h = self._act(self.norm1(self.conv1(x)))
        h = self.conv2(h)
        if not self.is_last:
            h = self._act(self.norm2(h))
        return h + (self.skip(x) if hasattr(self, "skip") else x)


class SelfAttention1d(nn.Module):
    """GroupNorm(1) -> 1x1 ``qkv_proj`` -> multi-head attention -> 1x1
    ``out_proj``, plus the input. The heads split the qkv channels as 3H
    blocks of C / H (q the first H)."""

    def __init__(self, c: int, n_head: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_head = n_head
        self.norm = GroupNorm(1, c, 1e-5, dtype)
        self.qkv_proj = Conv1d(c, 3 * c, 1, dtype=dtype)
        self.out_proj = Conv1d(c, c, 1, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        b, c, t = x.shape
        d = c // self.n_head
        qkv = self.qkv_proj(self.norm(x)).reshape(
            b, 3 * self.n_head, d, t).transpose(2, 3)
        q, k, v = qkv.chunk(3, dim=1)
        y = F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)
        return x + self.out_proj(y.transpose(2, 3).reshape(b, c, t))


class _DAULevel(nn.Module):
    """Level i (2 for the outermost): downsample (FIR cubic, or the learned
    ``down`` conv of kernel 2s + 1), three conv(+attention) blocks at
    channels[i - 1], the next level (``inner``), three more blocks back to
    channels[i - 2], upsample, and the level's input concatenated."""

    def __init__(self, i: int, depth: int, channels: Sequence[int],
                 strides: Sequence[int], attn_layer: int,
                 kernel_size: int = 5, conv_bias: bool = True,
                 use_snake: bool = False, learned_resample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, c_prev = channels[i - 1], channels[i - 2]
        s = strides[i - 1]
        self.stride, self.learned = s, learned_resample
        self.has_inner = i < depth

        def conv(name, cin, cm, co):
            self.add_module(name, ResConvBlock(cin, cm, co, False,
                                               kernel_size, conv_bias,
                                               use_snake, dtype))

        def attn(name, ch):
            self.add_module(name, SelfAttention1d(ch, max(ch // 32, 1), dtype)
                            if i >= attn_layer else nn.Identity())

        if learned_resample or s == 1:
            self.down = Conv1d(c_prev, c_prev, 2 * s + 1, stride=s,
                               padding=(s, s), dtype=dtype)
        conv("pre0", c_prev, c, c)
        attn("attn0", c)
        conv("pre1", c, c, c)
        attn("attn1", c)
        conv("pre2", c, c, c)
        attn("attn2", c)
        if self.has_inner:
            self.inner = _DAULevel(i + 1, depth, channels, strides,
                                   attn_layer, kernel_size, conv_bias,
                                   use_snake, learned_resample, dtype)
        conv("post0", 2 * c if self.has_inner else c, c, c)
        attn("attn3", c)
        conv("post1", c, c, c)
        attn("attn4", c)
        conv("post2", c, c, c_prev)
        attn("attn5", c_prev)
        if learned_resample:
            self.up = (Conv1d(c_prev, c_prev, 3, padding=(1, 1), dtype=dtype)
                       if s == 1 else
                       ConvTranspose1dSame(c_prev, c_prev, 2 * s, s, dtype))

    def forward(self, x: Tensor) -> Tensor:
        h = self.down(x) if hasattr(self, "down") else _fir_downsample(x)
        for name in ("pre0", "attn0", "pre1", "attn1", "pre2", "attn2"):
            h = getattr(self, name)(h)
        if self.has_inner:
            h = self.inner(h)
        for name in ("post0", "attn3", "post1", "attn4", "post2", "attn5"):
            h = getattr(self, name)(h)
        if self.learned:
            h = self.up(h)
        elif self.stride != 1:
            h = _fir_upsample(h)
        # (stride 1 without learned resampling keeps the length, as JAX)
        return torch.cat([h, x], dim=1)


class DiffusionAttnUnet1D(Seeded):
    """``forward(x (B, C, T), t (B,), cond=None) -> (B, C, T)``: the input,
    the timestep's Fourier features (``timestep_embed`` (8, 1), 16
    channels) and, where ``cond_dim``, the cond (B, cond_dim, Tc) resampled
    to T (with ``cond_noise_aug``: noise at a level, the level's features
    beside it) into the stem, the levels, the head. The noise
    augmentation's draws: ``aug_level`` (B,) and ``cond_noise`` (B,
    cond_dim, T) given, or from ``generator``; ``cond_aug_scale`` fixes
    the level."""

    def __init__(self, io_channels: int = 2, depth: int = 14,
                 n_attn_layers: int = 6,
                 channels: Sequence[int] = (128, 128, 256, 256) + (512,) * 10,
                 cond_dim: int = 0, cond_noise_aug: bool = False,
                 kernel_size: int = 5, learned_resample: bool = False,
                 strides: Sequence[int] = (2,) * 13, conv_bias: bool = True,
                 use_snake: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.io_channels, self.depth = io_channels, depth
        self.cond_dim, self.cond_noise_aug = cond_dim, cond_noise_aug
        self.timestep_embed = nn.Parameter(torch.randn(8, 1))
        c = channels[0]
        attn_layer = (depth - n_attn_layers if n_attn_layers > 0
                      else depth + 1)
        c_in = io_channels + 16 + (
            cond_dim + (16 if cond_noise_aug else 0) if cond_dim else 0)

        def conv(name, cin, cm, co, is_last=False):
            self.add_module(name, ResConvBlock(cin, cm, co, is_last,
                                               kernel_size, conv_bias,
                                               use_snake, dtype))

        conv("stem0", c_in, c, c)
        conv("stem1", c, c, c)
        conv("stem2", c, c, c)
        if depth > 1:
            self.inner = _DAULevel(2, depth, tuple(channels),
                                   (1,) + tuple(strides), attn_layer,
                                   kernel_size, conv_bias, use_snake,
                                   learned_resample, dtype)
        conv("head0", 2 * c if depth > 1 else c, c, c)
        conv("head1", c, c, c)
        conv("head2", c, c, io_channels, is_last=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.timestep_embed.normal_(0.0, 1.0, generator=generator)
        super().reset_parameters(generator)

    def forward(self, x: Tensor, t: Tensor, cond: Optional[Tensor] = None,
                cond_aug_scale: Optional[float] = None,
                aug_level: Optional[Tensor] = None,
                cond_noise: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        b, _, t_len = x.shape
        w = self.timestep_embed
        te = fourier_features(t.reshape(b, 1).float(), w)
        inputs = [x, te[:, :, None].expand(b, 16, t_len).to(x.dtype)]
        if cond is not None:
            cnd = linear_resize(cond, t_len)
            if self.cond_noise_aug:
                if cond_aug_scale is not None:
                    aug_level = torch.full((b,), float(cond_aug_scale),
                                           dtype=cnd.dtype, device=cnd.device)
                elif aug_level is None:
                    aug_level = torch.rand(b, generator=generator,
                                           device=generator.device)
                if cond_noise is None:
                    cond_noise = torch.randn(cnd.shape, generator=generator,
                                             device=generator.device)
                aug_level = aug_level.to(cnd)
                cnd = cnd + cond_noise.to(cnd) * aug_level[:, None, None]
                aug_emb = fourier_features(aug_level.reshape(b, 1), w)
                inputs.append(aug_emb[:, :, None].expand(b, 16, t_len))
            inputs.append(cnd)
        h = torch.cat(inputs, dim=1)
        for name in ("stem0", "stem1", "stem2"):
            h = getattr(self, name)(h)
        if self.depth > 1:
            h = self.inner(h)
        for name in ("head0", "head1", "head2"):
            h = getattr(self, name)(h)
        return h


@torch.no_grad()
def scale_params(model: nn.Module, factor: float = 0.5) -> nn.Module:
    """Every parameter times ``factor``, in place (the reference halves a
    fresh DAU1d's parameters, diffusion.py:470-472)."""
    for p in model.parameters():
        p.mul_(factor)
    return model


__all__ = ["ConvTranspose1dSame", "DiffusionAttnUnet1D", "ResConvBlock",
           "SelfAttention1d", "fourier_features", "linear_resize",
           "scale_params"]
