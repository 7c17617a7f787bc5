"""The codecs beyond Oobleck: DAC, SEANet, TAAE, local attention, and the
generic autoencoder that composes any of them (port of
ditsep_tpu/models/codecs.py; reference: stable-audio-tools
models/autoencoders.py:91-227, 359-537, 782-864, local_attention.py).

Layouts are NCW, as the port's Oobleck: every encoder maps audio (B, C, T)
to latents (B, D, T / hop) and every decoder back. The transformer levels
(TAAE, local attention) run on (B, T, C) inside.

Modules carry the JAX package's names (``stem``, ``block_{i}``, ``act``,
``final``, ``proj_out``...; the SEANet's ``res_{b}_{j}``, ``down_{b}``,
``up_{b}``, ``lstm``); the DAC and TAAE blocks reuse the port's Oobleck
``EncoderBlock`` / ``DecoderBlock`` / ``ResidualUnit``, whose
``flax_names`` map the JAX names onto the reference's ``nn.Sequential``
layout, so ``models.weights.params_from_jax(flat, model)`` carries a JAX
tree over.

The SEANet's LSTM is flax's ``nn.RNN(OptimizedLSTMCell)``: input kernels
``ii/if/ig/io`` without bias, hidden kernels ``hi/hf/hg/ho`` with bias,
gates i, f, g, o. ``SLSTM`` keeps those eight ``Dense`` layers under flax's
names (``OptimizedLSTMCell_{l}``) and runs them through ``torch.lstm``
(cuDNN on the card) with the input bias zero: the JAX package runs the
LSTM as a ``lax.scan`` outside any Pallas kernel.

The local-attention codec's neighbourhood attention of kernel k is a
(k // 2, k // 2) band mask, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.oobleck import (
    DecoderBlock, EncoderBlock, ResidualUnit, SnakeBeta, WNConv1d,
    WNConvTranspose1d, vae_sample,
)
from ditsep_tpu_torch.models.transformer import (
    Dense, Seeded, TransformerBlock, rotary_freqs,
)

Tensor = torch.Tensor


# ------------------------------------------------------------------ DAC --
class DACEncoderWrapper(Seeded):
    """DAC's encoder: a k=7 stem, snake ``EncoderBlock``s doubling the
    channels at each stride, SnakeBeta, a k=3 ``final`` conv to d_model *
    2^n channels, and the optional 1x1 ``proj_out`` to ``latent_dim``."""

    def __init__(self, d_model: int = 64, strides: Sequence[int] = (2, 4, 8, 8),
                 latent_dim: Optional[int] = None, in_channels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model, self.strides = d_model, tuple(int(s) for s in strides)
        self.latent_dim = latent_dim
        self.stem = WNConv1d(in_channels, d_model, 7, padding=3, dtype=dtype)
        ch = d_model
        for i, s in enumerate(self.strides):
            self.add_module(f"block_{i}", EncoderBlock(ch, 2 * ch, s, True,
                                                       dtype))
            ch *= 2
        self.act = SnakeBeta(ch)
        self.final = WNConv1d(ch, ch, 3, padding=1, dtype=dtype)
        if latent_dim is not None:
            self.proj_out = WNConv1d(ch, latent_dim, 1, padding=0,
                                     dtype=dtype)

    @property
    def hop_length(self) -> int:
        return math.prod(self.strides)

    def forward(self, x: Tensor) -> Tensor:
        x = self.stem(x)
        for i in range(len(self.strides)):
            x = getattr(self, f"block_{i}")(x)
        x = self.final(self.act(x))
        return self.proj_out(x) if self.latent_dim is not None else x


class DACDecoderWrapper(Seeded):
    """DAC's decoder: a k=7 stem to ``channels``, snake ``DecoderBlock``s
    halving the channels at each rate, SnakeBeta, a k=7 ``final`` conv,
    tanh."""

    def __init__(self, latent_dim: int, channels: int = 1536,
                 rates: Sequence[int] = (8, 8, 4, 2), out_channels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.rates = tuple(int(r) for r in rates)
        self.stem = WNConv1d(latent_dim, channels, 7, padding=3, dtype=dtype)
        ch = channels
        for i, r in enumerate(self.rates):
            self.add_module(f"block_{i}", DecoderBlock(ch, ch // 2, r, True,
                                                       dtype=dtype))
            ch //= 2
        self.act = SnakeBeta(ch)
        self.final = WNConv1d(ch, out_channels, 7, padding=3, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = self.stem(x)
        for i in range(len(self.rates)):
            x = getattr(self, f"block_{i}")(x)
        return torch.tanh(self.final(self.act(x)))


# --------------------------------------------------------------- SEANet --
class SEANetResnetBlock(Seeded):
    """ELU -> dilated conv (``conv_{i}``) per kernel size, compressing to
    dim / compress in between, plus a 1x1 ``shortcut`` (or the input with
    ``true_skip``)."""

    def __init__(self, dim: int, kernel_sizes: Sequence[int] = (3, 1),
                 dilations: Sequence[int] = (1, 1), compress: int = 2,
                 true_skip: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden, n = dim // compress, len(kernel_sizes)
        self.n, ch = n, dim
        for i, (k, d) in enumerate(zip(kernel_sizes, dilations)):
            out = dim if i == n - 1 else hidden
            self.add_module(f"conv_{i}", WNConv1d(
                ch, out, int(k), dilation=int(d),
                padding=(int(d) * (int(k) - 1)) // 2, dtype=dtype))
            ch = out
        if not true_skip:
            self.shortcut = WNConv1d(dim, dim, 1, padding=0, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for i in range(self.n):
            h = getattr(self, f"conv_{i}")(F.elu(h))
        short = self.shortcut(x) if hasattr(self, "shortcut") else x
        return short + h


class OptimizedLSTMCell(Seeded):
    """flax's ``OptimizedLSTMCell`` parameters: ``i{i,f,g,o}`` input
    kernels without bias, ``h{i,f,g,o}`` hidden kernels with bias."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for g in "ifgo":
            self.add_module(f"i{g}", Dense(in_features, features, bias=False))
            self.add_module(f"h{g}", Dense(features, features))

    def forward(self, x: Tensor) -> Tensor:
        """(B, T, in) -> (B, T, features), from zero state."""
        gates = [getattr(self, f"{k}{g}") for k in "ih" for g in "ifgo"]
        w_ih = torch.cat([m.weight for m in gates[:4]]).to(x.dtype)
        w_hh = torch.cat([m.weight for m in gates[4:]]).to(x.dtype)
        b_hh = torch.cat([m.bias for m in gates[4:]]).to(x.dtype)
        h0 = x.new_zeros((1, x.shape[0], w_hh.shape[1]))
        out, _, _ = torch.lstm(x.contiguous(), (h0, h0),
                               [w_ih, w_hh, torch.zeros_like(b_hh), b_hh],
                               True, 1, 0.0, False, False, True)
        return out


class SLSTM(Seeded):
    """``num_layers`` stacked LSTMs over (B, T, C), plus the input with
    ``skip``."""

    def __init__(self, features: int, num_layers: int = 2, skip: bool = True):
        super().__init__()
        self.num_layers, self.skip = num_layers, skip
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            OptimizedLSTMCell(features, features))

    def forward(self, x: Tensor) -> Tensor:
        y = x
        for i in range(self.num_layers):
            y = getattr(self, f"OptimizedLSTMCell_{i}")(y)
        return y + x if self.skip else y


class SEANetEncoder(Seeded):
    """The SEANet (encodec) encoder: a stem, per ratio (taken in reverse,
    as the reference reverses the configured decoder-order ratios)
    residual blocks, ELU and a strided ``down_{b}`` conv doubling the
    channels, the LSTM, ELU, a ``final`` conv to ``dimension``. Padding is
    the JAX package's symmetric scheme, not encodec's reflect padding."""

    def __init__(self, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, n_residual_layers: int = 1,
                 ratios: Sequence[int] = (8, 5, 4, 2), kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, true_skip: bool = False,
                 compress: int = 2, lstm: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ratios = tuple(int(r) for r in ratios)
        self.n_res, self.lstm_layers = n_residual_layers, lstm
        k, mult = kernel_size, 1
        self.stem = WNConv1d(channels, n_filters, k, padding=(k - 1) // 2,
                             dtype=dtype)
        for bi, r in enumerate(reversed(self.ratios)):
            ch = mult * n_filters
            for j in range(n_residual_layers):
                self.add_module(f"res_{bi}_{j}", SEANetResnetBlock(
                    ch, (residual_kernel_size, 1), (dilation_base ** j, 1),
                    compress, true_skip, dtype))
            self.add_module(f"down_{bi}", WNConv1d(
                ch, 2 * ch, 2 * r, stride=r, padding=math.ceil(r / 2),
                dtype=dtype))
            mult *= 2
        if lstm:
            self.lstm = SLSTM(mult * n_filters, num_layers=lstm)
        lk = last_kernel_size
        self.final = WNConv1d(mult * n_filters, dimension, lk,
                              padding=(lk - 1) // 2, dtype=dtype)

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)

    def forward(self, x: Tensor) -> Tensor:
        x = self.stem(x)
        for bi in range(len(self.ratios)):
            for j in range(self.n_res):
                x = getattr(self, f"res_{bi}_{j}")(x)
            x = getattr(self, f"down_{bi}")(F.elu(x))
        if self.lstm_layers:
            x = self.lstm(x.transpose(1, 2)).transpose(1, 2)
        return self.final(F.elu(x))


class SEANetDecoder(Seeded):
    """The SEANet decoder, the encoder's mirror: a stem, the LSTM, per
    ratio (in the configured order) ELU, a transposed ``up_{b}`` conv
    halving the channels, residual blocks; ELU, a ``final`` conv."""

    def __init__(self, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, n_residual_layers: int = 1,
                 ratios: Sequence[int] = (8, 5, 4, 2), kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, true_skip: bool = False,
                 compress: int = 2, lstm: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ratios = tuple(int(r) for r in ratios)
        self.n_res, self.lstm_layers = n_residual_layers, lstm
        mult, k = 2 ** len(self.ratios), kernel_size
        self.stem = WNConv1d(dimension, mult * n_filters, k,
                             padding=(k - 1) // 2, dtype=dtype)
        if lstm:
            self.lstm = SLSTM(mult * n_filters, num_layers=lstm)
        for bi, r in enumerate(self.ratios):
            ch = mult * n_filters
            self.add_module(f"up_{bi}", WNConvTranspose1d(
                ch, ch // 2, 2 * r, stride=r, padding=math.ceil(r / 2),
                dtype=dtype))
            for j in range(n_residual_layers):
                self.add_module(f"res_{bi}_{j}", SEANetResnetBlock(
                    ch // 2, (residual_kernel_size, 1),
                    (dilation_base ** j, 1), compress, true_skip, dtype))
            mult //= 2
        lk = last_kernel_size
        self.final = WNConv1d(mult * n_filters, channels, lk,
                              padding=(lk - 1) // 2, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = self.stem(x)
        if self.lstm_layers:
            x = self.lstm(x.transpose(1, 2)).transpose(1, 2)
        for bi in range(len(self.ratios)):
            x = getattr(self, f"up_{bi}")(F.elu(x))
            for j in range(self.n_res):
                x = getattr(self, f"res_{bi}_{j}")(x)
        return self.final(F.elu(x))


# ----------------------------------------------------------------- TAAE --
class _TransformerStack(Seeded):
    """``depth`` RoPE transformer blocks (``block_{i}``) over (B, T, dim),
    the rotary table built for each call's length."""

    def __init__(self, dim: int, depth: int, dim_heads: int, **block_kw):
        super().__init__()
        self.depth, self.dim_heads = depth, dim_heads
        for i in range(depth):
            self.add_module(f"block_{i}", TransformerBlock(
                dim, dim_heads=dim_heads, **block_kw))

    def forward(self, x: Tensor) -> Tensor:
        rot_dim = min(max(self.dim_heads // 2, 32), self.dim_heads)
        rope = rotary_freqs(x.shape[1], rot_dim).to(x.device)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, rotary_pos_emb=rope)
        return x


def _taae_stack(dim: int, depth: int, sliding_window, conformer: bool,
                layer_scale: bool, dtype) -> _TransformerStack:
    """The TAAE's stack: dim_heads min(128, dim), qk LayerNorm, norm eps
    1e-2, sliding windows, layer scale (then no zero init)."""
    return _TransformerStack(
        dim, depth, min(128, dim), zero_init_branch_outputs=not layer_scale,
        conformer=conformer, layer_scale=layer_scale, qk_norm="ln",
        sliding_window=tuple(sliding_window), norm_eps=1e-2, dtype=dtype)


class TAAEBlock(Seeded):
    """One TAAE level. Encoder: optional dilated residual units
    (``res_{i}``) at in_ch, the activation (SnakeBeta ``act``, or none), a
    strided ``down`` conv when the stride or width changes, then the
    ``transformer`` at out_ch. Decoder: the transformer at in_ch, the
    activation, a transposed ``up`` conv, the residual units at out_ch."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 kind: str = "encoder", transformer_depth: int = 3,
                 use_snake: bool = False,
                 sliding_window: Tuple[int, int] = (31, 32),
                 conformer: bool = False, layer_scale: bool = True,
                 use_dilated_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kind not in ("encoder", "decoder"):
            raise ValueError(f"kind must be encoder or decoder, not {kind!r}")
        self.kind, s = kind, int(stride)
        enc = kind == "encoder"
        res_ch = in_ch if enc else out_ch
        self.use_dilated_conv = use_dilated_conv
        if use_dilated_conv:
            for i, d in enumerate((1, 3, 9)):
                self.add_module(f"res_{i}", ResidualUnit(res_ch, d, use_snake,
                                                         dtype))
        self.act = SnakeBeta(in_ch) if use_snake else None
        if s > 1 or in_ch != out_ch:
            if enc:
                self.down = WNConv1d(in_ch, out_ch, 2 * s, stride=s,
                                     padding=math.ceil(s / 2), dtype=dtype)
            else:
                self.up = WNConvTranspose1d(in_ch, out_ch, 2 * s, stride=s,
                                            padding=math.ceil(s / 2),
                                            dtype=dtype)
        self.transformer = _taae_stack(out_ch if enc else in_ch,
                                       transformer_depth, sliding_window,
                                       conformer, layer_scale, dtype)

    def _res(self, x: Tensor) -> Tensor:
        if self.use_dilated_conv:
            for i in range(3):
                x = getattr(self, f"res_{i}")(x)
        return x

    def _xf(self, x: Tensor) -> Tensor:
        return self.transformer(x.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: Tensor) -> Tensor:
        if self.kind == "encoder":
            x = self._res(x)
            if self.act is not None:
                x = self.act(x)
            if hasattr(self, "down"):
                x = self.down(x)
            return self._xf(x)
        x = self._xf(x)
        if self.act is not None:
            x = self.act(x)
        if hasattr(self, "up"):
            x = self.up(x)
        return self._res(x)


class TAAEEncoder(Seeded):
    """A k=7 stem to channels * c_mults[0], a TAAE encoder level a stride,
    SnakeBeta with ``use_snake``, a k=3 ``final`` conv to latent_dim."""

    def __init__(self, in_channels: int = 2, channels: int = 128,
                 latent_dim: int = 32, c_mults: Sequence[int] = (1, 2, 4, 8),
                 strides: Sequence[int] = (2, 4, 8, 8),
                 transformer_depths: Sequence[int] = (3, 3, 3, 3),
                 use_snake: bool = False,
                 sliding_window: Tuple[int, int] = (63, 64),
                 conformer: bool = False, layer_scale: bool = True,
                 use_dilated_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.strides = tuple(int(s) for s in strides)
        dims = [c * channels for c in c_mults]
        dims = [dims[0]] + dims
        self.stem = WNConv1d(in_channels, dims[0], 7, padding=3, dtype=dtype)
        for i, s in enumerate(self.strides):
            self.add_module(f"block_{i}", TAAEBlock(
                dims[i], dims[i + 1], s, "encoder",
                int(transformer_depths[i]), use_snake, sliding_window,
                conformer, layer_scale, use_dilated_conv, dtype))
        self.act = SnakeBeta(dims[-1]) if use_snake else None
        self.final = WNConv1d(dims[-1], latent_dim, 3, padding=1, dtype=dtype)

    @property
    def hop_length(self) -> int:
        return math.prod(self.strides)

    def forward(self, x: Tensor) -> Tensor:
        x = self.stem(x)
        for i in range(len(self.strides)):
            x = getattr(self, f"block_{i}")(x)
        if self.act is not None:
            x = self.act(x)
        return self.final(x)


class TAAEDecoder(Seeded):
    """A k=3 stem to the deepest width, TAAE decoder levels deepest first,
    SnakeBeta with ``use_snake``, a bias-free k=7 ``final`` conv."""

    def __init__(self, out_channels: int = 2, channels: int = 128,
                 latent_dim: int = 32, c_mults: Sequence[int] = (1, 2, 4, 8),
                 strides: Sequence[int] = (2, 4, 8, 8),
                 transformer_depths: Sequence[int] = (3, 3, 3, 3),
                 use_snake: bool = False,
                 sliding_window: Tuple[int, int] = (63, 64),
                 conformer: bool = False, layer_scale: bool = True,
                 use_dilated_conv: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        strides = tuple(int(s) for s in strides)
        dims = [c * channels for c in c_mults]
        dims = [dims[0]] + dims
        self.n = len(strides)
        self.stem = WNConv1d(latent_dim, dims[-1], 3, padding=1, dtype=dtype)
        for j, i in enumerate(range(self.n, 0, -1)):
            self.add_module(f"block_{j}", TAAEBlock(
                dims[i], dims[i - 1], strides[i - 1], "decoder",
                int(transformer_depths[i - 1]), use_snake, sliding_window,
                conformer, layer_scale, use_dilated_conv, dtype))
        self.act = SnakeBeta(dims[0]) if use_snake else None
        self.final = WNConv1d(dims[0], out_channels, 7, padding=3, bias=False,
                              dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = self.stem(x)
        for j in range(self.n):
            x = getattr(self, f"block_{j}")(x)
        if self.act is not None:
            x = self.act(x)
        return self.final(x)


# ------------------------------------------------------ local attention --
def _local_stack(dim: int, depth: int, heads: int, window: int,
                 dtype) -> _TransformerStack:
    return _TransformerStack(
        dim, depth, dim // heads, sliding_window=(window // 2, window // 2),
        zero_init_branch_outputs=True, ff_mult=2.0, dtype=dtype)


class LocalTransformerEncoder1D(Seeded):
    """``project_in``, then per level: ``level_in_{i}`` where the width
    changes, a local transformer (``transformer_{i}``), length traded for
    channels ((B, n r, c) -> (B, n, c r)) and ``project_down_{i}`` back to
    the level's width; ``project_out``. Dense layers without bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 embed_dims: Sequence[int] = (96, 192, 384, 768),
                 heads: Sequence[int] = (12, 12, 12, 12),
                 depths: Sequence[int] = (3, 3, 3, 3),
                 ratios: Sequence[int] = (2, 2, 2, 2),
                 local_attn_window_size: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ratios = tuple(int(r) for r in ratios)
        self.project_in = Dense(in_channels, embed_dims[0], bias=False,
                                dtype=dtype)
        ch = embed_dims[0]
        for i, (dim, h, dpt, r) in enumerate(zip(embed_dims, heads, depths,
                                                 self.ratios)):
            if ch != dim:
                self.add_module(f"level_in_{i}", Dense(ch, dim, bias=False,
                                                       dtype=dtype))
            self.add_module(f"transformer_{i}", _local_stack(
                dim, int(dpt), int(h), local_attn_window_size, dtype))
            self.add_module(f"project_down_{i}", Dense(dim * r, dim,
                                                       bias=False,
                                                       dtype=dtype))
            ch = dim
        self.project_out = Dense(ch, out_channels, bias=False, dtype=dtype)

    @property
    def hop_length(self) -> int:
        return math.prod(self.ratios)

    def forward(self, x: Tensor) -> Tensor:
        x = self.project_in(x.transpose(1, 2))
        for i, r in enumerate(self.ratios):
            if hasattr(self, f"level_in_{i}"):
                x = getattr(self, f"level_in_{i}")(x)
            x = getattr(self, f"transformer_{i}")(x)
            b, n, c = x.shape
            x = getattr(self, f"project_down_{i}")(x.reshape(b, n // r,
                                                             c * r))
        return self.project_out(x).transpose(1, 2)


class LocalTransformerDecoder1D(Seeded):
    """The mirror: ``project_in``, per level ``level_in_{i}`` where the
    width changes, ``project_up_{i}`` to width x r, channels traded for
    length, the local transformer; ``project_out``."""

    def __init__(self, in_channels: int, out_channels: int,
                 embed_dims: Sequence[int] = (768, 384, 192, 96),
                 heads: Sequence[int] = (12, 12, 12, 12),
                 depths: Sequence[int] = (3, 3, 3, 3),
                 ratios: Sequence[int] = (2, 2, 2, 2),
                 local_attn_window_size: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ratios = tuple(int(r) for r in ratios)
        self.project_in = Dense(in_channels, embed_dims[0], bias=False,
                                dtype=dtype)
        ch = embed_dims[0]
        for i, (dim, h, dpt, r) in enumerate(zip(embed_dims, heads, depths,
                                                 self.ratios)):
            if ch != dim:
                self.add_module(f"level_in_{i}", Dense(ch, dim, bias=False,
                                                       dtype=dtype))
            self.add_module(f"project_up_{i}", Dense(dim, dim * r, bias=False,
                                                     dtype=dtype))
            self.add_module(f"transformer_{i}", _local_stack(
                dim, int(dpt), int(h), local_attn_window_size, dtype))
            ch = dim
        self.project_out = Dense(ch, out_channels, bias=False, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = self.project_in(x.transpose(1, 2))
        for i, r in enumerate(self.ratios):
            if hasattr(self, f"level_in_{i}"):
                x = getattr(self, f"level_in_{i}")(x)
            x = getattr(self, f"project_up_{i}")(x)
            b, n, c = x.shape
            x = getattr(self, f"transformer_{i}")(x.reshape(b, n * r, c // r))
        return self.project_out(x).transpose(1, 2)


# -------------------------------------------------------------- generic --
class GenericAudioAutoencoder(Seeded):
    """Encoder + bottleneck + decoder for any pair: audio (B, C, T),
    latents (B, D, Tl). ``bottleneck_type``: 'none', 'vae' (the encoder
    gives mean and scale), 'tanh', 'l2_norm' or 'rvq' (a ``ResidualVQ``,
    ``quantizer``, whose codes and loss go in the info)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 latent_dim: int, bottleneck_type: str = "none",
                 bottleneck_config: Optional[dict] = None,
                 soft_clip: bool = False):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.latent_dim, self.soft_clip = latent_dim, soft_clip
        self.bottleneck_type = bottleneck_type
        if bottleneck_type == "rvq":
            from ditsep_tpu_torch.models.bottleneck import ResidualVQ
            c = dict(bottleneck_config or {})
            self.quantizer = ResidualVQ(
                dim=c.get("dim", latent_dim),
                codebook_size=c.get("codebook_size", 1024),
                num_quantizers=c.get("num_quantizers", 4))
        elif bottleneck_type not in ("none", "vae", "tanh", "l2_norm"):
            raise NotImplementedError(
                f"bottleneck {bottleneck_type!r} is not supported by "
                "GenericAudioAutoencoder")

    @property
    def downsampling_ratio(self) -> int:
        return int(self.encoder.hop_length)

    def encode(self, audio: Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Tensor] = None, return_info: bool = False):
        """(B, C, T) -> (B, D, Tl); a 'vae' bottleneck samples with
        ``generator`` or the standard-normal ``noise`` (B, D, Tl), else
        takes the mean."""
        h = self.encoder(audio)
        info = {"kl": h.new_zeros(())}
        kind = self.bottleneck_type
        if kind == "vae":
            mean, scale = h.chunk(2, dim=1)
            if generator is None and noise is None:
                lat = mean
            else:
                if noise is None:
                    noise = torch.randn(mean.shape, generator=generator,
                                        device=mean.device)
                lat, info["kl"] = vae_sample(mean, scale, noise)
        elif kind == "tanh":
            lat = torch.tanh(h)
        elif kind == "l2_norm":
            lat = h / (torch.linalg.vector_norm(h, dim=1, keepdim=True) + 1e-8)
        elif kind == "rvq":
            lat, codes, loss = self.quantizer(h.transpose(1, 2))
            lat = lat.transpose(1, 2)
            info.update(codes=codes, quantizer_loss=loss)
        else:
            lat = h
        return (lat, info) if return_info else lat

    def decode(self, latents: Tensor) -> Tensor:
        """(B, D, Tl) -> (B, C, T)."""
        y = self.decoder(latents)
        return torch.tanh(y) if self.soft_clip else y

    def forward(self, audio: Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tensor] = None):
        latents, info = self.encode(audio, generator, noise,
                                    return_info=True)
        return self.decode(latents), {**info, "latents": latents}


__all__ = ["DACDecoderWrapper", "DACEncoderWrapper", "GenericAudioAutoencoder",
           "LocalTransformerDecoder1D", "LocalTransformerEncoder1D", "SLSTM",
           "SEANetDecoder", "SEANetEncoder", "SEANetResnetBlock", "TAAEBlock",
           "TAAEDecoder", "TAAEEncoder"]
