"""Building-block layers of the NCSN++ backbone (PyTorch, logical NCHW).

Port of ditsep_tpu/models/layers.py. Submodule and parameter names are the
reference torch names (Conv_0, GroupNorm_1, NIN_3, Dense_0, ...), so
``state_dict`` keys match the original DiTSep checkpoints and the weight
bridge (models/weights.py) is a rename plus a layout transpose.

``dtype`` on a layer is the compute dtype, as the JAX package's ``dtype``
field: parameters stay float32 and are cast, with the input, to ``dtype``
(None keeps the input's dtype). GroupNorm statistics are float32, as in
flax.

Masked scoring (``mask_padding``): a (B, W) boolean frame mask ``tmask``
marks the valid time columns. GroupNorm then takes its statistics over the
valid columns only and attention gives no weight to keys in invalid ones;
``tmask=None`` is the reference semantics, the exact unmasked call.

Parameters are initialised by ``reset_parameters(generator)`` with the JAX
package's initialisers (``default_init``: variance scaling, fan_avg,
uniform; Fourier W ~ N(0, scale^2); zero biases).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.ops import fir

Tensor = torch.Tensor


def default_init(tensor: Tensor, scale: float = 1.0, *, fan_in: int,
                 fan_out: int, generator: Optional[torch.Generator] = None
                 ) -> Tensor:
    """DDPM initializer: variance scaling with fan_avg, uniform
    (ditsep_tpu/models/layers.py:28-33). Fans are passed explicitly since
    torch and flax lay weights out differently."""
    scale = 1e-10 if scale == 0 else scale
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        return tensor.uniform_(-limit, limit, generator=generator)


def get_act(name: str) -> Callable[[Tensor], Tensor]:
    """Activation registry."""
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError(f"activation function {name!r} does not exist")


def _compute_dtype(layer_dtype: Optional[torch.dtype], x: Tensor):
    return layer_dtype or x.dtype


class Conv2d(nn.Conv2d):
    """nn.Conv2d with DDPM init and a compute dtype (cuDNN on the card)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 padding: int = 0, bias: bool = True, init_scale: float = 1.0,
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        self.init_scale = init_scale
        super().__init__(in_ch, out_ch, kernel_size, padding=padding,
                         bias=bias, stride=stride)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        rf = self.kernel_size[0] * self.kernel_size[1]
        default_init(self.weight, self.init_scale,
                     fan_in=self.in_channels * rf,
                     fan_out=self.out_channels * rf, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        dt = _compute_dtype(self.compute_dtype, x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b,
                        padding=self.padding, stride=self.stride)


def conv3x3(in_ch: int, out_ch: int, *, bias: bool = True,
            init_scale: float = 1.0, dtype=None) -> Conv2d:
    """3x3 conv, padding 1, DDPM-initialized."""
    return Conv2d(in_ch, out_ch, 3, padding=1, bias=bias,
                  init_scale=init_scale, dtype=dtype)


def conv1x1(in_ch: int, out_ch: int, *, bias: bool = True,
            init_scale: float = 1.0, dtype=None) -> Conv2d:
    """1x1 conv, DDPM-initialized."""
    return Conv2d(in_ch, out_ch, 1, bias=bias, init_scale=init_scale,
                  dtype=dtype)


class Linear(nn.Linear):
    """nn.Linear (weight (out, in)) with DDPM init and a compute dtype."""

    def __init__(self, in_features: int, out_features: int, *, dtype=None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        default_init(self.weight, 1.0, fan_in=self.in_features,
                     fan_out=self.out_features, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        dt = _compute_dtype(self.compute_dtype, x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


# An unmasked GroupNorm with at most GN_PLAIN_MAX_ROWS (item, group) rows,
# each longer than GN_PLAIN_MIN_ROW values, takes its statistics by plain
# reductions; any other by F.group_norm. F.group_norm reduces each row in
# one thread block, so a few long rows (DAU1d's GroupNorm(1) of one item
# over 65,536 steps: one row of 8.4 M values) leave the card nearly idle,
# while the plain reductions' half-dozen launches cost more than a short
# row. Chosen from ditsep_tpu_torch/scripts/groupnorm_timing.py (PERF.md
# section 6: H100 times at NCSN++'s and DAU1d's shapes).
GN_PLAIN_MAX_ROWS = 32
GN_PLAIN_MIN_ROW = 1 << 18


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm`` over NC... (NCHW or NCW) with a compute
    dtype (the output's; statistics in float32)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float,
                 dtype=None):
        super().__init__(num_groups, num_channels, eps=eps)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """Per (item, group), in float32 over the group's channels and
        the trailing axes, flax's fast statistics: mean = E[x], var =
        max(E[x^2] - E[x]^2, 0); every element is then normalized and
        given the affine transform. ``mask`` (B, 1, 1, W) bool, for NCHW:
        the statistics over the valid columns only, as flax's
        ``GroupNorm(mask=...)``; masked elements are normalized too.
        Unmasked, unless the rows are few and long (``GN_PLAIN_MAX_ROWS``,
        ``GN_PLAIN_MIN_ROW``), ``F.group_norm`` computes it (its exact
        variance: the same up to rounding)."""
        dt = _compute_dtype(self.compute_dtype, x)
        b, c = x.shape[:2]
        g = self.num_groups
        if mask is None and not (b * g <= GN_PLAIN_MAX_ROWS
                                 and x[0].numel() // g > GN_PLAIN_MIN_ROW):
            return F.group_norm(x.to(dt), g, self.weight.to(dt),
                                self.bias.to(dt), self.eps)
        xg = x.to(dt).float().reshape(b, g, c // g, *x.shape[2:])
        dims = tuple(range(2, xg.ndim))
        if mask is None:
            mean = xg.mean(dim=dims, keepdim=True)
            mean2 = (xg * xg).mean(dim=dims, keepdim=True)
        else:
            m = mask.to(torch.float32)[:, None]          # (B, 1, 1, 1, W)
            count = m.sum(dim=dims, keepdim=True) * (
                c // g * math.prod(x.shape[2:-1]))
            xm = xg * m
            mean = xm.sum(dim=dims, keepdim=True) / count
            mean2 = (xm * xg).sum(dim=dims, keepdim=True) / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = (1, g, c // g) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().reshape(shape)
        y = (xg - mean) * mul + self.bias.float().reshape(shape)
        return y.reshape(x.shape).to(dt)


def time_mask_to_gn(tmask: Optional[Tensor]) -> Optional[Tensor]:
    """(B, W) frame mask -> the (B, 1, 1, W) GroupNorm mask of an NCHW
    activation whose last axis is time; None stays None."""
    return None if tmask is None else tmask[:, None, None, :]


def pool_time_mask(tmask: Tensor) -> Tensor:
    """Downsample a (B, W) frame mask by 2, following the U-Net's
    resolution ladder: a pooled column is valid if either of its two
    source columns was. An odd width is padded with one invalid column
    first (ditsep_tpu/models/layers.py:86-94)."""
    if tmask.shape[-1] % 2:
        tmask = F.pad(tmask, (0, 1), value=False)
    return tmask[:, ::2] | tmask[:, 1::2]


def group_norm(ch: int, *, dtype=None) -> GroupNorm:
    """GroupNorm(min(ch//4, 32) groups, eps 1e-6), as throughout NCSN++."""
    return GroupNorm(min(ch // 4, 32), ch, eps=1e-6, dtype=dtype)


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of the (log) noise level. ``W`` is sampled
    once and never trained: a buffer."""

    def __init__(self, embedding_size: int = 256, scale: float = 16.0):
        super().__init__()
        self.scale = scale
        self.register_buffer("W", torch.empty(embedding_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.W.normal_(0.0, self.scale, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        x_proj = x[:, None] * self.W[None, :] * 2.0 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class NIN(nn.Module):
    """1x1 'network-in-network' over the channel axis; ``W`` is (in, out)
    as in the reference torch layer."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1,
                 dtype=None):
        super().__init__()
        self.init_scale = init_scale
        self.compute_dtype = dtype
        self.W = nn.Parameter(torch.empty(in_dim, num_units))
        self.b = nn.Parameter(torch.empty(num_units))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        default_init(self.W, self.init_scale, fan_in=self.W.shape[0],
                     fan_out=self.W.shape[1], generator=generator)
        nn.init.zeros_(self.b)

    def forward(self, x: Tensor) -> Tensor:
        dt = _compute_dtype(self.compute_dtype, x)
        y = torch.einsum("bchw,cd->bdhw", x.to(dt), self.W.to(dt))
        return y + self.b.to(dt)[None, :, None, None]


class Combine(nn.Module):
    """Combine a skip connection: conv1x1 then cat or sum."""

    def __init__(self, dim1: int, dim2: int, method: str = "cat", dtype=None):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"Method {method} not recognized.")
        self.method = method
        self.Conv_0 = conv1x1(dim1, dim2, dtype=dtype)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        h = self.Conv_0(x)
        if self.method == "cat":
            return torch.cat([h, y], dim=1)
        return h + y


class AttnBlockpp(nn.Module):
    """Spatial self-attention over the H*W positions with per-channel
    features. Plain matmul + softmax, as the JAX package computes it
    outside Pallas (ditsep_tpu/models/layers.py:193-203)."""

    def __init__(self, channels: int, skip_rescale: bool = False,
                 init_scale: float = 0.0, dtype=None):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(channels, dtype=dtype)
        self.NIN_0 = NIN(channels, channels, dtype=dtype)
        self.NIN_1 = NIN(channels, channels, dtype=dtype)
        self.NIN_2 = NIN(channels, channels, dtype=dtype)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale,
                         dtype=dtype)

    def forward(self, x: Tensor, tmask: Optional[Tensor] = None) -> Tensor:
        """``tmask`` (B, W): the GroupNorm's statistics over valid frames,
        and the logits of keys in invalid frames set to -1e9 (not -inf,
        as the JAX package) before the softmax."""
        b, c, hh, ww = x.shape
        h = self.GroupNorm_0(x, time_mask_to_gn(tmask))
        q = self.NIN_0(h).reshape(b, c, hh * ww)
        k = self.NIN_1(h).reshape(b, c, hh * ww)
        v = self.NIN_2(h).reshape(b, c, hh * ww)
        w = torch.matmul(q.transpose(1, 2), k) * (c ** -0.5)  # (b, q, k)
        if tmask is not None:  # key (f, t) is valid iff frame t is
            kmask = tmask[:, None, :].expand(b, hh, ww).reshape(
                b, 1, hh * ww)
            w = torch.where(kmask, w, torch.full_like(w, -1e9))
        w = torch.softmax(w, dim=-1)
        h = torch.matmul(v, w.transpose(1, 2)).reshape(b, c, hh, ww)
        h = self.NIN_3(h)
        if not self.skip_rescale:
            return x + h
        return (x + h) / math.sqrt(2.0)


class ResampleConv2d(Conv2d):
    """The StyleGAN2 conv with fused FIR up- or downsampling
    (ditsep_tpu/models/layers.py:211-245): ``up`` a stride-2 transposed
    conv then the FIR filter (``fir.upsample_conv_2d``), ``down`` the
    filter then a stride-2 conv (``fir.conv_downsample_2d``), else a 'SAME'
    conv. DDPM-initialized; the weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 up: bool = False, down: bool = False,
                 resample_kernel: Sequence[float] = (1, 3, 3, 1),
                 use_bias: bool = True, dtype=None):
        assert not (up and down)
        super().__init__(in_ch, out_ch, kernel, bias=use_bias, dtype=dtype)
        self.up, self.down = up, down
        self.resample_kernel = tuple(resample_kernel)

    def forward(self, x: Tensor) -> Tensor:
        dt = _compute_dtype(self.compute_dtype, x)
        x, w = x.to(dt), self.weight.to(dt)
        if self.up:
            x = fir.upsample_conv_2d(x, w, k=self.resample_kernel)
        elif self.down:
            x = fir.conv_downsample_2d(x, w, k=self.resample_kernel)
        else:
            x = F.conv2d(x, w, padding=self.kernel_size[0] // 2)
        if self.bias is not None:
            x = x + self.bias.to(dt)[None, :, None, None]
        return x


class Upsample(nn.Module):
    """2x upsampling: FIR, optionally fused with a 3x3 conv
    (``Conv2d_0``, a ``ResampleConv2d``), or nearest, optionally followed
    by a 3x3 conv (``Conv_0``). ``in_ch`` is needed with a conv (flax
    infers it); ``out_ch`` defaults to it."""

    def __init__(self, in_ch: Optional[int] = None,
                 out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = True,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        self.fir, self.with_conv = fir, with_conv
        self.fir_kernel = tuple(fir_kernel)
        out_ch = out_ch or in_ch
        if with_conv and fir:
            self.Conv2d_0 = ResampleConv2d(in_ch, out_ch, 3, up=True,
                                           resample_kernel=fir_kernel,
                                           dtype=dtype)
        elif with_conv:
            self.Conv_0 = conv3x3(in_ch, out_ch, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        if self.fir:
            if self.with_conv:
                return self.Conv2d_0(x)
            return fir.upsample_2d(x, self.fir_kernel, factor=2)
        h = fir.naive_upsample_2d(x, factor=2)
        return self.Conv_0(h) if self.with_conv else h


class Downsample(nn.Module):
    """2x downsampling: FIR (``fir_down2d`` on the card), optionally fused
    with a 3x3 conv (``Conv2d_0``, a ``ResampleConv2d``), or average
    pooling, or with a conv a zero pad (right and bottom) and a stride-2
    3x3 conv (``Conv_0``)."""

    def __init__(self, in_ch: Optional[int] = None,
                 out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = True,
                 fir_kernel: Sequence[float] = (1, 3, 3, 1), dtype=None):
        super().__init__()
        self.fir, self.with_conv = fir, with_conv
        self.fir_kernel = tuple(fir_kernel)
        out_ch = out_ch or in_ch
        if with_conv and fir:
            self.Conv2d_0 = ResampleConv2d(in_ch, out_ch, 3, down=True,
                                           resample_kernel=fir_kernel,
                                           dtype=dtype)
        elif with_conv:
            self.Conv_0 = Conv2d(in_ch, out_ch, 3, stride=2, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        if self.fir:
            if self.with_conv:
                return self.Conv2d_0(x)
            return fir.downsample_2d(x, self.fir_kernel, factor=2)
        if self.with_conv:
            return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class ResnetBlockDDPMpp(nn.Module):
    """The DDPM residual block (ditsep_tpu/models/layers.py:316-354): norm,
    act, 3x3 conv, + the time embedding, norm, act, dropout, 3x3 conv; the
    shortcut a 3x3 conv (``conv_shortcut``) or NIN where the width
    changes."""

    def __init__(self, act: Callable[[Tensor], Tensor], in_ch: int,
                 out_ch: Optional[int] = None, temb_dim: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.1,
                 skip_rescale: bool = False, init_scale: float = 0.0,
                 dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act, self.skip_rescale = act, skip_rescale
        self.GroupNorm_0 = group_norm(in_ch, dtype=dtype)
        self.Conv_0 = conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = Linear(temb_dim, out_ch, dtype=dtype)
        self.GroupNorm_1 = group_norm(out_ch, dtype=dtype)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale,
                              dtype=dtype)
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = conv3x3(in_ch, out_ch, dtype=dtype)
            else:
                self.NIN_0 = NIN(in_ch, out_ch, dtype=dtype)

    def forward(self, x: Tensor, temb: Optional[Tensor] = None, *,
                tmask: Optional[Tensor] = None) -> Tensor:
        """``tmask`` masks both GroupNorms' statistics (the block keeps
        its resolution)."""
        gm = time_mask_to_gn(tmask)
        h = self.Conv_0(self.act(self.GroupNorm_0(x, gm)))
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        h = self.Conv_1(self.Dropout_0(self.act(self.GroupNorm_1(h, gm))))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        elif hasattr(self, "NIN_0"):
            x = self.NIN_0(x)
        if not self.skip_rescale:
            return x + h
        return (x + h) / math.sqrt(2.0)


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with optional FIR up/down resampling
    (ditsep_tpu/models/layers.py:357-421)."""

    def __init__(self, act: Callable[[Tensor], Tensor], in_ch: int,
                 out_ch: Optional[int] = None, temb_dim: Optional[int] = None,
                 up: bool = False, down: bool = False, dropout: float = 0.1,
                 fir: bool = True, fir_kernel: Sequence[float] = (1, 3, 3, 1),
                 skip_rescale: bool = True, init_scale: float = 0.0,
                 dtype=None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.up, self.down = up, down
        self.fir = fir
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = group_norm(in_ch, dtype=dtype)
        self.Conv_0 = conv3x3(in_ch, out_ch, dtype=dtype)
        if temb_dim is not None:
            self.Dense_0 = Linear(temb_dim, out_ch, dtype=dtype)
        self.GroupNorm_1 = group_norm(out_ch, dtype=dtype)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = conv3x3(out_ch, out_ch, init_scale=init_scale,
                              dtype=dtype)
        if in_ch != out_ch or up or down:
            self.Conv_2 = conv1x1(in_ch, out_ch, dtype=dtype)

    def _resample(self, x: Tensor) -> Tensor:
        if self.up:
            if self.fir:
                return fir.upsample_2d(x, self.fir_kernel, factor=2)
            return fir.naive_upsample_2d(x, factor=2)
        if self.down:
            if self.fir:
                return fir.downsample_2d(x, self.fir_kernel, factor=2)
            return fir.naive_downsample_2d(x, factor=2)
        return x

    def forward(self, x: Tensor, temb: Optional[Tensor] = None, *,
                tmask: Optional[Tensor] = None,
                tmask_out: Optional[Tensor] = None) -> Tensor:
        """``tmask`` masks GroupNorm_0's statistics at the input
        resolution, ``tmask_out`` GroupNorm_1's at the resolution after
        the up or down step (``tmask`` when the block keeps it)."""
        h = self.act(self.GroupNorm_0(x, time_mask_to_gn(tmask)))
        h = self._resample(h)
        x = self._resample(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, :, None, None]
        mask_out = tmask_out if (self.up or self.down) else tmask
        h = self.act(self.GroupNorm_1(h, time_mask_to_gn(mask_out)))
        h = self.Dropout_0(h)
        h = self.Conv_1(h)
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        if not self.skip_rescale:
            return x + h
        return (x + h) / math.sqrt(2.0)
