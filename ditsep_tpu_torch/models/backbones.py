"""Alternative separation backbones: the Conv-TasNet TCN, the dual-path
transformer (DPTNet) and the DiffuSE residual dilated diffusion net (port
of ditsep_tpu/models/backbones.py; reference: src/models/diffsep/
tcn.py:18-296, dptnet.py:14-181, cdiffuse_network.py:27-164).

Activations are channel-last (B, T, C), as in the JAX package; the public
entry points take the reference's (B, C, T). Submodules carry the flax
names (``block_{r}_{i}``, ``self_attn.query``, ``rnn_fwd.cell.ii``...), so
``models.weights.params_from_jax`` loads a JAX tree:

* flax's ``MultiHeadDotProductAttention`` keeps (d, heads, head_dim)
  kernels and an (heads, head_dim, d) output kernel; the bridge transposes
  a 3-D kernel end for end, and ``DenseGeneral`` reads it back that way;
* flax names an RNN's cell in the layer that makes it
  (``OptimizedLSTMCell_0`` forward, ``_1`` backward; ``GRUCell_{0,1}``),
  which ``flax_names`` maps onto ``rnn_fwd.cell`` / ``rnn_bwd.cell``;
* flax's ``OptimizedLSTMCell`` (input kernels ``i{i,f,g,o}`` without bias,
  hidden kernels ``h{i,f,g,o}`` with) and ``GRUCell`` (``ir``, ``iz``,
  ``in`` with biases; ``hr``, ``hz`` without; ``hn`` with, inside the
  reset product) run as ``torch.lstm`` / ``torch.gru`` with the kernels
  stacked in torch's gate orders (i, f, g, o and r, z, n): torch's
  ``b_hn`` sits inside the reset product as flax's ``hn`` bias does. From
  zero state; ``reverse`` runs the time-flipped sequence and flips the
  output back (flax's ``reverse=True, keep_order=True``).

Everything is stock PyTorch (cuDNN convs and RNNs, cuBLAS, SDPA), as the
JAX package computes these outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.codecs import OptimizedLSTMCell
from ditsep_tpu_torch.models.normalization import (
    ChannelwiseLayerNorm, choose_norm,
)
from ditsep_tpu_torch.models.transformer import Conv1d, Dense, Seeded

Tensor = torch.Tensor


class ConvNTC(Conv1d):
    """flax's 1-D ``nn.Conv`` on channel-last (B, T, C): 'same' padding
    (k - 1) * dilation // 2 on both sides."""

    def __init__(self, in_ch: int, out_ch: int, k: int, *, dilation: int = 1,
                 bias: bool = True, groups: int = 1):
        pad = (k - 1) * dilation // 2
        super().__init__(in_ch, out_ch, k, padding=(pad, pad), groups=groups,
                         bias=bias)
        self.dilation = (dilation,)

    def forward(self, x: Tensor) -> Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), b,
                     padding=self.pad[0], dilation=self.dilation,
                     groups=self.groups)
        return y.transpose(1, 2)


class PReLU(nn.Module):
    """One slope ``alpha`` (0.25) for x < 0."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def reset_parameters(self, generator=None):
        nn.init.constant_(self.alpha, 0.25)

    def forward(self, x: Tensor) -> Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class DenseGeneral(nn.Module):
    """A flax ``DenseGeneral`` of the attention: ``split`` (d -> heads x
    head_dim, kernel (d, h, hd) stored (hd, h, d)) or, not ``split``, its
    output (h x hd -> d, kernel (h, hd, d) stored (d, hd, h)); computed as
    one (B, T, h*hd) matmul, heads outer."""

    def __init__(self, d: int, heads: int, head_dim: int, split: bool):
        super().__init__()
        self.split = split
        if split:
            self.weight = nn.Parameter(torch.empty(head_dim, heads, d))
            self.bias = nn.Parameter(torch.zeros(heads, head_dim))
        else:
            self.weight = nn.Parameter(torch.empty(d, head_dim, heads))
            self.bias = nn.Parameter(torch.zeros(d))
        self.fan_in = d if split else heads * head_dim
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.fan_in ** -0.5, generator=generator)
            self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        if self.split:
            w = self.weight.permute(1, 0, 2).flatten(0, 1)   # (h*hd, d)
        else:
            w = self.weight.permute(0, 2, 1).flatten(1, 2)   # (d, h*hd)
        return F.linear(x, w.to(x.dtype), self.bias.reshape(-1).to(x.dtype))


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (q / sqrt(head_dim), softmax,
    no mask) over (B, T, d), qkv and output widths ``qkv_features`` and
    ``out_features`` (default d)."""

    def __init__(self, d: int, num_heads: int,
                 qkv_features: Optional[int] = None,
                 out_features: Optional[int] = None):
        super().__init__()
        qkv = qkv_features or d
        self.heads, self.head_dim = num_heads, qkv // num_heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral(d, num_heads, self.head_dim,
                                               True))
        self.out = DenseGeneral(out_features or d, num_heads, self.head_dim,
                                False)

    def forward(self, x: Tensor) -> Tensor:
        b, t, _ = x.shape

        def heads(m):
            return m(x).reshape(b, t, self.heads, self.head_dim).transpose(
                1, 2)

        y = F.scaled_dot_product_attention(heads(self.query),
                                           heads(self.key),
                                           heads(self.value))
        return self.out(y.transpose(1, 2).reshape(b, t, -1))


class GRUCell(Seeded):
    """flax's ``GRUCell`` parameters (``ir``, ``iz``, ``in`` with bias,
    ``hr``, ``hz`` without, ``hn`` with) run over a sequence by
    ``torch.gru``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        for g in "rzn":
            self.add_module(f"i{g}", Dense(in_features, features))
            self.add_module(f"h{g}", Dense(features, features,
                                           bias=(g == "n")))

    def forward(self, x: Tensor) -> Tensor:
        """(B, T, in) -> (B, T, features), from zero state."""
        dt = x.dtype
        w_ih = torch.cat([getattr(self, f"i{g}").weight for g in "rzn"])
        w_hh = torch.cat([getattr(self, f"h{g}").weight for g in "rzn"])
        b_ih = torch.cat([getattr(self, f"i{g}").bias for g in "rzn"])
        zero = torch.zeros_like(self.hn.bias)
        b_hh = torch.cat([zero, zero, self.hn.bias])
        h0 = x.new_zeros((1, x.shape[0], w_hh.shape[1]))
        out, _ = torch.gru(x.contiguous(), h0,
                           [w.to(dt) for w in (w_ih, w_hh, b_ih, b_hh)],
                           True, 1, 0.0, False, False, True)
        return out


class RNN(nn.Module):
    """flax's ``nn.RNN`` over (B, T, C) from zero state; ``reverse`` reads
    the sequence backwards and returns it in the input's order."""

    def __init__(self, cell: nn.Module, reverse: bool = False):
        super().__init__()
        self.cell, self.reverse = cell, reverse

    def forward(self, x: Tensor) -> Tensor:
        if not self.reverse:
            return self.cell(x)
        return self.cell(x.flip(1)).flip(1)


def _rnn_cell(rnn_type: str, d: int, hidden: int) -> nn.Module:
    return (GRUCell if rnn_type.lower() == "gru" else OptimizedLSTMCell)(
        d, hidden)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise dilated conv, PReLU, norm, pointwise conv (no biases)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dilation: int, norm_type: str = "gLN"):
        super().__init__()
        self.depthwise = ConvNTC(in_ch, in_ch, kernel_size,
                                 dilation=dilation, bias=False,
                                 groups=in_ch)
        self.prelu = PReLU()
        self.norm = choose_norm(norm_type, in_ch)
        self.pointwise = ConvNTC(in_ch, out_ch, 1, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return self.pointwise(self.norm(self.prelu(self.depthwise(x))))


class TemporalBlock(nn.Module):
    """1x1 conv to ``hidden``, PReLU, norm, the depthwise-separable conv
    back to the input width, plus the input."""

    def __init__(self, in_ch: int, hidden: int, kernel_size: int,
                 dilation: int, norm_type: str = "gLN"):
        super().__init__()
        self.conv1x1 = ConvNTC(in_ch, hidden, 1, bias=False)
        self.prelu = PReLU()
        self.norm = choose_norm(norm_type, hidden)
        self.dsconv = DepthwiseSeparableConv(hidden, in_ch, kernel_size,
                                             dilation, norm_type)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.dsconv(self.norm(self.prelu(self.conv1x1(x))))


class TemporalConvNet(Seeded):
    """The Conv-TasNet mask network: ``forward(mixture_w (B, N, K))`` ->
    (B, C, N, K) masks."""

    def __init__(self, N: int = 256, B: int = 256, H: int = 512, P: int = 3,
                 X: int = 8, R: int = 4, C: int = 2, norm_type: str = "gLN",
                 mask_nonlinear: str = "relu"):
        super().__init__()
        if mask_nonlinear not in ("softmax", "relu", "sigmoid", "tanh"):
            raise ValueError("Unsupported mask non-linear function")
        self.N, self.C, self.X, self.R = N, C, X, R
        self.mask_nonlinear = mask_nonlinear
        self.layer_norm = ChannelwiseLayerNorm(N)
        self.bottleneck = ConvNTC(N, B, 1, bias=False)
        for r in range(R):
            for i in range(X):
                self.add_module(f"block_{r}_{i}", TemporalBlock(
                    B, H, P, 2 ** i, norm_type))
        self.mask_conv = ConvNTC(B, C * N, 1, bias=False)

    def forward(self, mixture_w: Tensor) -> Tensor:
        x = self.bottleneck(self.layer_norm(mixture_w.transpose(1, 2)))
        for r in range(self.R):
            for i in range(self.X):
                x = getattr(self, f"block_{r}_{i}")(x)
        score = self.mask_conv(x).transpose(1, 2)  # (B, C*N, K)
        score = score.reshape(score.shape[0], self.C, self.N, -1)
        if self.mask_nonlinear == "softmax":
            return torch.softmax(score, dim=1)
        if self.mask_nonlinear == "relu":
            return F.relu(score)
        if self.mask_nonlinear == "sigmoid":
            return torch.sigmoid(score)
        return torch.tanh(score)


class ImprovedTransformerLayer(nn.Module):
    """The DPT layer over (B, T, d): self-attention + the input, norm; a
    (bidirectional) RNN, ReLU, ``ff_out`` back to d, + its input, norm."""

    def __init__(self, d: int, att_heads: int = 4, hidden_size: int = 128,
                 rnn_type: str = "lstm", bidirectional: bool = True,
                 norm: str = "gLN"):
        super().__init__()
        self.bidirectional = bidirectional
        self.self_attn = MultiHeadDotProductAttention(d, att_heads)
        self.norm_attn = choose_norm(norm, d)
        self.rnn_fwd = RNN(_rnn_cell(rnn_type, d, hidden_size))
        if bidirectional:
            self.rnn_bwd = RNN(_rnn_cell(rnn_type, d, hidden_size),
                               reverse=True)
        self.ff_out = Dense(hidden_size * (2 if bidirectional else 1), d)
        self.norm_ff = choose_norm(norm, d)
        # flax names the cells in the layer, in the order they are made
        cell = "GRUCell" if rnn_type.lower() == "gru" else "OptimizedLSTMCell"
        self.flax_names = {f"{cell}_0": "rnn_fwd.cell",
                           f"{cell}_1": "rnn_bwd.cell"}

    def forward(self, x: Tensor) -> Tensor:
        out = self.norm_attn(self.self_attn(x) + x)
        h = self.rnn_fwd(out)
        if self.bidirectional:
            h = torch.cat([h, self.rnn_bwd(out)], dim=-1)
        return self.norm_ff(self.ff_out(F.relu(h)) + out)


class DPTNet(Seeded):
    """The dual-path transformer: ``forward(x (B, D, T))`` -> (B,
    output_size, T). The time axis is zero-padded to chunks of
    ``chunk_size``; intra-chunk and inter-chunk layers alternate
    (``norm_type`` is unused, as in the JAX package: the layers take
    gLN)."""

    def __init__(self, input_size: int, output_size: int,
                 hidden_size: int = 128, att_heads: int = 4,
                 num_layers: int = 2, chunk_size: int = 100,
                 rnn_type: str = "lstm", norm_type: str = "gLN"):
        super().__init__()
        self.num_layers, self.chunk_size = num_layers, chunk_size
        for i in range(num_layers):
            for kind in ("intra", "inter"):
                self.add_module(f"{kind}_{i}", ImprovedTransformerLayer(
                    input_size, att_heads, hidden_size, rnn_type))
        self.out_prelu = PReLU()
        self.out_proj = Dense(input_size, output_size)

    def forward(self, x: Tensor) -> Tensor:
        b, d, t = x.shape
        cs = self.chunk_size
        pad = (-t) % cs
        if pad:
            x = F.pad(x, (0, pad))
        n = x.shape[-1] // cs
        h = x.reshape(b, d, n, cs)
        for i in range(self.num_layers):
            hi = h.permute(0, 2, 3, 1).reshape(b * n, cs, d)
            hi = getattr(self, f"intra_{i}")(hi)
            h = hi.reshape(b, n, cs, d).permute(0, 3, 1, 2)
            he = h.permute(0, 3, 2, 1).reshape(b * cs, n, d)
            he = getattr(self, f"inter_{i}")(he)
            h = he.reshape(b, cs, n, d).permute(0, 3, 2, 1)
        h = h.reshape(b, d, -1)[..., :t].transpose(1, 2)
        return self.out_proj(self.out_prelu(h)).transpose(1, 2)


class DiffusionEmbedding(nn.Module):
    """The DiffuSE step embedding: a 128-wide sin / cos table over
    ``max_steps`` steps, read at t * 50 with linear interpolation between
    steps, then two SiLU-activated 512-wide projections."""

    def __init__(self, max_steps: int = 50):
        super().__init__()
        self.max_steps = max_steps
        steps = np.arange(max_steps)[:, None]
        dims = np.arange(64)[None, :]
        table = steps * 10.0 ** (dims * 4.0 / 63.0)
        self.register_buffer("table", torch.from_numpy(np.concatenate(
            [np.sin(table), np.cos(table)], axis=1).astype(np.float32)),
            persistent=False)
        self.projection1 = Dense(128, 512)
        self.projection2 = Dense(512, 512)

    def forward(self, t: Tensor) -> Tensor:
        tt = t * 50.0
        low = torch.clamp(torch.floor(tt).long(), 0, self.max_steps - 1)
        high = torch.clamp(torch.ceil(tt).long(), 0, self.max_steps - 1)
        frac = (tt - torch.floor(tt))[:, None]
        x = self.table[low] + (self.table[high] - self.table[low]) * frac
        x = F.silu(self.projection1(x))
        return F.silu(self.projection2(x))


class DiffuSEResidualBlock(nn.Module):
    """A gated dilated residual block: (x + step) through a dilated conv,
    plus the conditioner's, sigmoid-tanh gate, 1x1 convs to the residual
    and the skip."""

    def __init__(self, residual_channels: int, dilation: int):
        super().__init__()
        c = residual_channels
        self.diffusion_projection = Dense(512, c)
        self.dilated_cond_conv = ConvNTC(c, 2 * c, 3, dilation=dilation)
        self.dilated_conv = ConvNTC(c, 2 * c, 3, dilation=dilation)
        self.output_residual = ConvNTC(c, c, 1)
        self.output_projection = ConvNTC(c, c, 1)

    def forward(self, x: Tensor, t_emb: Tensor, cond: Tensor):
        step = self.diffusion_projection(t_emb)[:, None, :]
        y = self.dilated_conv(x + step) + self.dilated_cond_conv(cond)
        gate, filt = y.chunk(2, dim=-1)
        y = torch.sigmoid(gate) * torch.tanh(filt)
        return ((x + self.output_residual(y)) / math.sqrt(2.0),
                self.output_projection(y))


class DiffuSE(Seeded):
    """The CDiffuSE conditional diffusion net: ``forward(xt (B, 1, T), t
    (B,), cond (B, 1, T))`` -> (B, 1, T)."""

    def __init__(self, residual_channels: int = 64,
                 residual_layers: int = 30,
                 dilation_cycle_length: int = 10, max_steps: int = 50):
        super().__init__()
        c = residual_channels
        self.residual_layers = residual_layers
        self.input_projection = ConvNTC(1, c, 1)
        self.cond_projection = ConvNTC(1, c, 1)
        self.step_embed = DiffusionEmbedding(max_steps)
        for i in range(residual_layers):
            self.add_module(f"res_{i}", DiffuSEResidualBlock(
                c, 2 ** (i % dilation_cycle_length)))
        self.skip_projection = ConvNTC(c, c, 1)
        self.output_projection = ConvNTC(c, 1, 1)

    def forward(self, xt: Tensor, t: Tensor, cond: Tensor) -> Tensor:
        h = F.relu(self.input_projection(xt.transpose(1, 2)))
        cond_h = F.relu(self.cond_projection(cond.transpose(1, 2)))
        t_emb = self.step_embed(t)
        skips = None
        for i in range(self.residual_layers):
            h, skip = getattr(self, f"res_{i}")(h, t_emb, cond_h)
            skips = skip if skips is None else skips + skip
        h = skips / math.sqrt(self.residual_layers)
        h = F.relu(self.skip_projection(h))
        return self.output_projection(h).transpose(1, 2)
