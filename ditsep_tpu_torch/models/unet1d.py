"""The 1-D diffusion U-Nets of the audio-diffusion-pytorch lineage (port of
ditsep_tpu/models/unet1d.py; reference: stable-audio-tools models/adp.py):
``UNet1d`` (time mapping, context features, context channels,
cross-attention embeddings, patching, skip scaling), ``UNetCFG1d``
(classifier-free guidance with a learned null context), ``UNetNCCA1d``
(noise-channel conditioning augmentation), ``NumberEmbedder``,
``FixedEmbedding``, ``UNetCondAdapter`` and ``create_unet_from_config``.

Layouts are NCW; the attention blocks run on (B, T, C) inside. The convs
pad as the JAX package's do, with explicit and uneven pairs: (k // 2,
(k - 1) // 2) at stride 1, ((k - s) // 2, (k - s + 1) // 2) strided,
(f // 2 + f % 2, f // 2) for the pooling, (k - 1, 0) when causal. GELU is
JAX's default tanh approximation; GroupNorm's epsilon flax's 1e-6.

Modules carry the JAX package's names (``down_{i}_{b}``,
``down_attn_{i}_{b}``, ``down_pool_{i}``, ``mid_{0,1}``, ``up_pool_{i}``,
``up_conv_{i}``, ``out_norm``...), so ``models.weights.params_from_jax``
carries a JAX tree over.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.dit import FourierFeatures
from ditsep_tpu_torch.models.layers import GroupNorm
from ditsep_tpu_torch.models.lm import Embed
from ditsep_tpu_torch.models.transformer import (
    Attention, Conv1d, Dense, Seeded,
)

Tensor = torch.Tensor


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _gn_groups(ch: int, max_groups: int) -> int:
    """The largest group count <= max_groups (and ch // 4) dividing ch."""
    g = max(1, min(ch // 4, max_groups))
    while ch % g:
        g -= 1
    return g


def _conv(in_ch: int, out_ch: int, k: int = 3, stride: int = 1,
          causal: bool = False, dtype=None) -> Conv1d:
    if causal:
        pad = (k - 1, 0) if stride == 1 else (k - stride, 0)
    elif stride == 1:
        pad = (k // 2, (k - 1) // 2)
    else:
        pad = ((k - stride) // 2, (k - stride + 1) // 2)
    return Conv1d(in_ch, out_ch, k, stride=stride, padding=pad, dtype=dtype)


class ResBlock1d(nn.Module):
    """GroupNorm -> SiLU -> conv, twice, FiLM from the mapping vector
    (``film``) between; a 1x1 ``skip`` where the width changes; the sum
    over sqrt(2)."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 8,
                 causal: bool = False, temb_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_0 = GroupNorm(_gn_groups(in_ch, groups), in_ch, 1e-6, dtype)
        self.conv_0 = _conv(in_ch, out_ch, causal=causal, dtype=dtype)
        self.norm_1 = GroupNorm(_gn_groups(out_ch, groups), out_ch, 1e-6,
                                dtype)
        if temb_dim:
            self.film = Dense(temb_dim, 2 * out_ch, dtype=dtype)
        self.conv_1 = _conv(out_ch, out_ch, causal=causal, dtype=dtype)
        if in_ch != out_ch:
            self.skip = Conv1d(in_ch, out_ch, 1, dtype=dtype)

    def forward(self, x: Tensor, temb: Optional[Tensor]) -> Tensor:
        h = self.conv_0(F.silu(self.norm_0(x)))
        h2 = self.norm_1(h)
        if temb is not None:
            scale, shift = self.film(F.silu(temb))[:, :, None].chunk(2, dim=1)
            h2 = h2 * (1 + scale) + shift
        h = self.conv_1(F.silu(h2))
        if hasattr(self, "skip"):
            x = self.skip(x)
        return (x + h) / math.sqrt(2.0)


class AttnBlock1d(nn.Module):
    """Self-attention (inner width heads x min(dim_head, C), projected back
    to C), cross-attention over context tokens where ``context_dim`` is
    set, and a GELU-gated feed-forward (``ff_in`` to 8 C, ``ff_out``
    zero-initialised), each after a GroupNorm, each residual."""

    def __init__(self, c: int, heads: int = 8, dim_head: int = 64,
                 causal: bool = False, context_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dim_heads = min(dim_head, c)
        inner = heads * dim_heads
        g = _gn_groups(c, 32)
        self.norm = GroupNorm(g, c, 1e-6, dtype)
        self.attn = Attention(inner, dim_heads=dim_heads, dim_out=c,
                              causal=causal, zero_init_output=True,
                              dtype=dtype, dim_in=c)
        if context_dim:
            self.cross_norm = GroupNorm(g, c, 1e-6, dtype)
            self.cross_attn = Attention(inner, dim_heads=dim_heads, dim_out=c,
                                        dim_context=context_dim,
                                        zero_init_output=True, dtype=dtype,
                                        dim_in=c)
        self.ff_norm = GroupNorm(g, c, 1e-6, dtype)
        self.ff_in = Dense(c, 8 * c, dtype=dtype)
        self.ff_out = Dense(4 * c, c, dtype=dtype, zero_init=True)

    def forward(self, x: Tensor, context: Optional[Tensor] = None,
                context_mask: Optional[Tensor] = None) -> Tensor:
        """x (B, C, T); context (B, S, D) tokens with their (B, S) mask."""
        x = x + self.attn(self.norm(x).transpose(1, 2)).transpose(1, 2)
        if context is not None:
            h = self.cross_attn(self.cross_norm(x).transpose(1, 2),
                                context=context, mask=context_mask)
            x = x + h.transpose(1, 2)
        u, v = self.ff_in(self.ff_norm(x).transpose(1, 2)).chunk(2, dim=-1)
        return x + self.ff_out(u * _gelu(v)).transpose(1, 2)


class NumberEmbedder(Seeded):
    """Raw scalars of any shape -> (..., features): Fourier features
    (``fourier``) then ``proj``."""

    def __init__(self, features: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.fourier = FourierFeatures(1, features)
        self.proj = Dense(features, features, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        shape = x.shape
        h = self.proj(self.fourier(x.float().reshape(-1, 1)))
        return h.reshape(shape + (self.features,))


class FixedEmbedding(Embed):
    """The learned CFG null context: the first n rows of a (max_length,
    features) table (``embedding``, N(0, 1)), broadcast over the batch."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, n_tokens: int, batch: int) -> Tensor:
        if n_tokens > self.num_embeddings:
            raise ValueError(f"context length {n_tokens} exceeds max "
                             f"{self.num_embeddings}")
        return self.weight[None, :n_tokens].expand(batch, n_tokens,
                                                   self.embedding_dim)


def _padded(seq: Sequence[int], n: int) -> List[int]:
    return list(seq) + [0] * (n - len(seq))


class UNet1d(Seeded):
    """The core U-Net: ``forward(x (B, C, T), t (B,), ...) -> (B, C', T)``
    (C' = ``out_channels`` or in_channels)."""

    def __init__(self, in_channels: int = 2, channels: int = 64,
                 multipliers: Sequence[int] = (1, 2, 4, 4),
                 factors: Sequence[int] = (2, 2, 2),
                 num_blocks: Sequence[int] = (2, 2, 2),
                 attentions: Sequence[int] = (0, 0, 1, 1),
                 patch_size: int = 1, resnet_groups: int = 8,
                 out_channels: Optional[int] = None,
                 use_skip_scale: bool = True, use_context_time: bool = True,
                 context_features: Optional[int] = None,
                 context_channels: Sequence[int] = (),
                 context_embedding_features: Optional[int] = None,
                 attention_heads: int = 8, attention_features: int = 64,
                 causal: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = len(factors)
        if not len(num_blocks) == n == len(multipliers) - 1:
            raise ValueError("num_blocks and factors need len(multipliers) "
                             "- 1 entries")
        self.factors, self.num_blocks = tuple(factors), tuple(num_blocks)
        self.patch_size, self.channels = patch_size, channels
        self.in_channels = in_channels
        self.use_skip_scale = use_skip_scale
        self.use_context_time = use_context_time
        self.context_features = context_features
        self.context_embedding_features = context_embedding_features
        self.ctx = _padded(context_channels, n + 1)
        a = _padded(attentions, n + 1)
        # the bottleneck reads attentions[n], or attentions[n - 1] when
        # the list is shorter
        self.layer_attn = a[:n]
        self.has_mid_attn = bool(a[n] if len(attentions) > n else a[n - 1])
        temb = channels * 4 if (use_context_time or context_features) \
            else None
        if use_context_time:
            self.time_features = FourierFeatures(1, channels)
            self.to_time = Dense(channels, temb, dtype=dtype)
        if context_features:
            self.to_features = Dense(context_features, temb, dtype=dtype)
        if temb:
            self.mapping_0 = Dense(temb, temb, dtype=dtype)
            self.mapping_1 = Dense(temb, temb, dtype=dtype)

        def res(name, cin, cout):
            self.add_module(name, ResBlock1d(cin, cout, resnet_groups,
                                             causal, temb, dtype))

        def attn(name, c):
            self.add_module(name, AttnBlock1d(
                c, attention_heads, attention_features, causal,
                context_embedding_features, dtype))

        h = channels * multipliers[0]
        self.stem = _conv((in_channels + self.ctx[0]) * patch_size, h,
                          causal=causal, dtype=dtype)
        skips = [h]
        for i in range(n):
            ch = channels * multipliers[i + 1]
            for b in range(num_blocks[i]):
                res(f"down_{i}_{b}", h, ch)
                h = ch
                if self.layer_attn[i]:
                    attn(f"down_attn_{i}_{b}", ch)
                skips.append(h)
            f = factors[i]
            self.add_module(f"down_pool_{i}", Conv1d(
                h, ch, 2 * f, stride=f, padding=(f // 2 + f % 2, f // 2),
                dtype=dtype))
            h = ch + self.ctx[i + 1]
            skips.append(h)
        res("mid_0", h, h)
        if self.has_mid_attn:
            attn("mid_attn", h)
        res("mid_1", h, h)
        for i in reversed(range(n)):
            ch = channels * multipliers[i + 1]
            res(f"up_pool_{i}", h + skips.pop(), ch)
            h = ch
            self.add_module(f"up_conv_{i}", _conv(ch, ch, causal=causal,
                                                  dtype=dtype))
            for b in range(num_blocks[i]):
                res(f"up_{i}_{b}", h + skips.pop(), ch)
                if self.layer_attn[i]:
                    attn(f"up_attn_{i}_{b}", ch)
        h += skips.pop()
        self.out_norm = GroupNorm(_gn_groups(h, 32), h, 1e-6, dtype)
        self.out_conv = _conv(h, (out_channels or in_channels) * patch_size,
                              causal=causal, dtype=dtype)

    def forward(self, x: Tensor, t: Optional[Tensor] = None, *,
                features: Optional[Tensor] = None,
                channels_list: Optional[Sequence[Tensor]] = None,
                embedding: Optional[Tensor] = None,
                embedding_mask: Optional[Tensor] = None) -> Tensor:
        n = len(self.factors)
        ch_id = 0

        def take_channels(h, layer):
            nonlocal ch_id
            if self.ctx[layer] <= 0:
                return h
            if channels_list is None:
                raise ValueError(f"context channels declared at layer {layer}"
                                 " but no channels_list passed")
            c = channels_list[ch_id]
            ch_id += 1
            if c.shape[1] != self.ctx[layer]:
                raise ValueError(f"layer {layer} expects {self.ctx[layer]} "
                                 f"context channels, got {c.shape[1]}")
            return torch.cat([h, c.to(h.dtype)], dim=1)

        temb = None
        if self.use_context_time or self.context_features:
            items = []
            if self.use_context_time:
                items.append(self.to_time(self.time_features(
                    t.float()[:, None])))
            if self.context_features:
                if features is None:
                    raise ValueError("context_features is configured: pass "
                                     "features")
                items.append(self.to_features(features))
            temb = _gelu(self.mapping_1(self.mapping_0(_gelu(sum(items)))))

        h = take_channels(x, 0)
        p = self.patch_size
        if p > 1:  # fold p time steps into channels: channel pi * C + c
            b, c, tt = h.shape
            if tt % p:
                raise ValueError(f"length {tt} not divisible by patch {p}")
            h = h.reshape(b, c, tt // p, p).permute(0, 3, 1, 2).reshape(
                b, p * c, tt // p)
        h = self.stem(h)
        skip_scale = 1.0 / math.sqrt(2.0) if self.use_skip_scale else 1.0
        ctx = embedding if self.context_embedding_features else None
        skips = [h]
        for i in range(n):
            for b in range(self.num_blocks[i]):
                h = getattr(self, f"down_{i}_{b}")(h, temb)
                if self.layer_attn[i]:
                    h = getattr(self, f"down_attn_{i}_{b}")(h, ctx,
                                                            embedding_mask)
                skips.append(h)
            h = take_channels(getattr(self, f"down_pool_{i}")(h), i + 1)
            skips.append(h)
        h = self.mid_0(h, temb)
        if self.has_mid_attn:
            h = self.mid_attn(h, ctx, embedding_mask)
        h = self.mid_1(h, temb)
        for i in reversed(range(n)):
            h = getattr(self, f"up_pool_{i}")(
                torch.cat([h, skips.pop() * skip_scale], dim=1), temb)
            h = getattr(self, f"up_conv_{i}")(
                torch.repeat_interleave(h, self.factors[i], dim=-1))
            for b in range(self.num_blocks[i]):
                h = getattr(self, f"up_{i}_{b}")(
                    torch.cat([h, skips.pop() * skip_scale], dim=1), temb)
                if self.layer_attn[i]:
                    h = getattr(self, f"up_attn_{i}_{b}")(h, ctx,
                                                          embedding_mask)
        h = torch.cat([h, skips.pop() * skip_scale], dim=1)
        h = self.out_conv(F.silu(self.out_norm(h)))
        if p > 1:  # unpatch: channel pi * C + c back to time
            b, cp, tt = h.shape
            h = h.reshape(b, p, cp // p, tt).permute(0, 2, 3, 1).reshape(
                b, cp // p, tt * p)
        return h


class UNetCFG1d(Seeded):
    """``UNet1d`` with classifier-free guidance: the learned null context
    (``fixed_embedding``) replaces the embedding with probability
    ``embedding_mask_proba`` in training (the draw ``cfg_drop`` (B,) bool,
    or from ``generator``), and ``embedding_scale`` != 1 runs the
    conditioned and the null (or negative) branch in one batched call and
    blends them, with optional std rescaling (``rescale_cfg``,
    ``scale_phi``). ``use_xattn_time`` appends a time token."""

    def __init__(self, context_embedding_max_length: int = 64,
                 context_embedding_features: int = 768,
                 use_xattn_time: bool = False, in_channels: int = 2,
                 channels: int = 64,
                 multipliers: Sequence[int] = (1, 2, 4, 4),
                 factors: Sequence[int] = (2, 2, 2),
                 num_blocks: Sequence[int] = (2, 2, 2),
                 attentions: Sequence[int] = (0, 0, 1, 1),
                 patch_size: int = 1, resnet_groups: int = 8,
                 out_channels: Optional[int] = None,
                 use_skip_scale: bool = True,
                 context_features: Optional[int] = None,
                 context_channels: Sequence[int] = (),
                 attention_heads: int = 8, attention_features: int = 64,
                 causal: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_xattn_time = use_xattn_time
        if use_xattn_time:
            self.xattn_time = FourierFeatures(1, channels)
            self.to_time_embedding = Dense(channels,
                                           context_embedding_features,
                                           dtype=dtype)
        self.fixed_embedding = FixedEmbedding(
            context_embedding_max_length + (1 if use_xattn_time else 0),
            context_embedding_features)
        self.unet = UNet1d(
            in_channels=in_channels, channels=channels,
            multipliers=multipliers, factors=factors, num_blocks=num_blocks,
            attentions=attentions, patch_size=patch_size,
            resnet_groups=resnet_groups, out_channels=out_channels,
            use_skip_scale=use_skip_scale, context_features=context_features,
            context_channels=context_channels,
            context_embedding_features=context_embedding_features,
            attention_heads=attention_heads,
            attention_features=attention_features, causal=causal,
            dtype=dtype)

    def forward(self, x: Tensor, t: Tensor, *, embedding: Tensor,
                embedding_mask: Optional[Tensor] = None,
                embedding_scale: float = 1.0,
                embedding_mask_proba: float = 0.0,
                cfg_drop: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rescale_cfg: bool = False, scale_phi: float = 0.4,
                negative_embedding: Optional[Tensor] = None,
                negative_embedding_mask: Optional[Tensor] = None,
                features: Optional[Tensor] = None,
                channels_list: Optional[Sequence[Tensor]] = None) -> Tensor:
        b = embedding.shape[0]
        if self.use_xattn_time:
            te = _gelu(self.to_time_embedding(self.xattn_time(
                t.float()[:, None])))
            embedding = torch.cat([embedding, te[:, None].to(embedding)],
                                  dim=1)
            if embedding_mask is not None:
                embedding_mask = torch.cat([embedding_mask, torch.ones_like(
                    embedding_mask[:, :1])], dim=1)
        fixed = self.fixed_embedding(embedding.shape[1], b)
        if embedding_mask_proba > 0.0:
            if cfg_drop is None:
                if generator is None:
                    raise ValueError("embedding_mask_proba needs cfg_drop or "
                                     "a generator")
                cfg_drop = torch.rand(b, generator=generator,
                                      device=generator.device
                                      ) < embedding_mask_proba
            embedding = torch.where(cfg_drop.reshape(b, 1, 1).to(
                embedding.device), fixed.to(embedding), embedding)
        if embedding_scale == 1.0:
            return self.unet(x, t, embedding=embedding,
                             embedding_mask=embedding_mask, features=features,
                             channels_list=channels_list)
        null = fixed.to(embedding)
        if negative_embedding is not None:
            null = negative_embedding
            if negative_embedding_mask is not None:
                null = torch.where(negative_embedding_mask.bool()[..., None],
                                   negative_embedding, fixed.to(embedding))

        def two(a):
            return None if a is None else torch.cat([a, a], dim=0)

        out2 = self.unet(
            two(x), two(t), embedding=torch.cat([embedding, null], dim=0),
            embedding_mask=two(embedding_mask), features=two(features),
            channels_list=(None if channels_list is None
                           else [two(c) for c in channels_list]))
        out, out_null = out2.chunk(2, dim=0)
        out_cfg = out_null + (out - out_null) * embedding_scale
        if rescale_cfg:
            out_std = out.std(dim=1, keepdim=True, correction=0)
            cfg_std = out_cfg.std(dim=1, keepdim=True, correction=0)
            return (scale_phi * out_cfg * (out_std / (cfg_std + 1e-8))
                    + (1.0 - scale_phi) * out_cfg)
        return out_cfg


class UNetNCCA1d(Seeded):
    """Noise-channel conditioning augmentation: each context channel map
    blends toward noise by its item's scale (noise * s + item * (1 - s);
    the noise ``noise`` (one tensor an item), from ``generator``, or zero),
    and the scales, embedded (``embedder``), are the U-Net's context
    features."""

    def __init__(self, context_features: int = 256, in_channels: int = 2,
                 channels: int = 64,
                 multipliers: Sequence[int] = (1, 2, 4, 4),
                 factors: Sequence[int] = (2, 2, 2),
                 num_blocks: Sequence[int] = (2, 2, 2),
                 attentions: Sequence[int] = (0, 0, 1, 1),
                 context_channels: Sequence[int] = (),
                 resnet_groups: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embedder = NumberEmbedder(context_features, dtype)
        self.unet = UNet1d(
            in_channels=in_channels, channels=channels,
            multipliers=multipliers, factors=factors, num_blocks=num_blocks,
            attentions=attentions, context_features=context_features,
            context_channels=context_channels, resnet_groups=resnet_groups,
            dtype=dtype)

    def forward(self, x: Tensor, t: Tensor, *,
                channels_list: Sequence[Tensor], channels_scale=0.0,
                noise: Optional[Sequence[Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Tensor:
        b, n = x.shape[0], len(channels_list)
        scale = torch.as_tensor(channels_scale, dtype=torch.float32,
                                device=x.device).expand(b, n)
        aug = []
        for i, item in enumerate(channels_list):
            if noise is not None:
                z = noise[i].to(item)
            elif generator is not None:
                z = torch.randn(item.shape, generator=generator,
                                device=generator.device).to(item)
            else:
                z = torch.zeros_like(item)
            s = scale[:, i].reshape(-1, 1, 1)
            aug.append(z * s + item * (1.0 - s))
        features = self.embedder(scale).sum(dim=1)
        return self.unet(x, t, features=features, channels_list=aug)


def XUNet1d(type: str = "base", **kwargs):
    """The type dispatch: 'base', 'cfg' or 'ncca'."""
    nets = {"base": UNet1d, "cfg": UNetCFG1d, "ncca": UNetNCCA1d}
    if type not in nets:
        raise ValueError(f"Unknown XUNet1d type: {type}")
    return nets[type](**kwargs)


class UNetCondAdapter(Seeded):
    """The diffusion trainer's and generator's conditioning names onto a
    ``UNetCFG1d`` (cross-attention tokens as the embedding, CFG knobs
    honoured) or a plain ``UNet1d`` (``net``): ``input_concat_cond`` is the
    context channels, ``global_embed`` the context features. It samples as
    a 'v' model (``diffusion_objective``). ``scale_phi``, which
    ``generate_diffusion_cond`` passes every model, is accepted and unused,
    as the reference wrapper's ``**kwargs`` swallow it (the JAX package's
    adapter refuses it); prepended conditioning is unused, as in JAX."""

    diffusion_objective = "v"

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    @property
    def io_channels(self) -> int:
        unet = self.net.unet if isinstance(self.net, UNetCFG1d) else self.net
        return unet.in_channels

    def forward(self, x: Tensor, t: Tensor,
                cross_attn_cond: Optional[Tensor] = None,
                cross_attn_cond_mask: Optional[Tensor] = None,
                input_concat_cond: Optional[Tensor] = None,
                global_embed: Optional[Tensor] = None,
                prepend_cond: Optional[Tensor] = None,
                prepend_cond_mask: Optional[Tensor] = None,
                cfg_scale: float = 1.0, cfg_dropout_prob: float = 0.0,
                cfg_drop: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None,
                rescale_cfg: bool = False, scale_phi: float = 0.0) -> Tensor:
        channels_list = ([input_concat_cond] if input_concat_cond is not None
                         else None)
        if isinstance(self.net, UNetCFG1d):
            if cross_attn_cond is None:
                raise ValueError("adp_cfg_1d needs cross-attention "
                                 "conditioning")
            return self.net(
                x, t, embedding=cross_attn_cond,
                embedding_mask=cross_attn_cond_mask, features=global_embed,
                channels_list=channels_list, embedding_scale=cfg_scale,
                embedding_mask_proba=cfg_dropout_prob, cfg_drop=cfg_drop,
                generator=generator, rescale_cfg=rescale_cfg)
        return self.net(x, t, features=global_embed,
                        channels_list=channels_list)


def create_unet_from_config(diffusion_model_type: str, cfg) -> UNetCondAdapter:
    """The adp U-Net family from a reference JSON diffusion config
    ('adp_cfg_1d' or 'adp_1d'), wrapped in a ``UNetCondAdapter``; its
    weights from the global generator (the factory seeds them)."""
    c = {k: tuple(v) if isinstance(v, list) else v for k, v in dict(
        cfg).items()}
    common = dict(
        in_channels=c.get("in_channels", 2),
        out_channels=c.get("out_channels"),
        channels=c.get("channels", 64),
        multipliers=c.get("multipliers", (1, 2, 4, 4)),
        factors=c.get("factors", (2, 2, 2)),
        num_blocks=c.get("num_blocks", (2, 2, 2)),
        attentions=c.get("attentions", (0, 0, 1, 1)),
        patch_size=c.get("patch_size", 1),
        resnet_groups=c.get("resnet_groups", 8),
        context_features=c.get("context_features"),
        context_channels=c.get("context_channels", ()),
        attention_heads=c.get("attention_heads", 8),
        attention_features=c.get("attention_features", 64))
    if diffusion_model_type == "adp_cfg_1d":
        net = UNetCFG1d(
            context_embedding_max_length=c.get(
                "context_embedding_max_length", 64),
            context_embedding_features=c.get(
                "context_embedding_features", 768),
            use_xattn_time=c.get("use_xattn_time", False), **common)
    elif diffusion_model_type == "adp_1d":
        net = UNet1d(context_embedding_features=c.get(
            "context_embedding_features"), **common)
    else:
        raise ValueError(f"unknown adp type {diffusion_model_type!r}")
    return UNetCondAdapter(net)


__all__ = ["AttnBlock1d", "FixedEmbedding", "NumberEmbedder", "ResBlock1d",
           "UNet1d", "UNetCFG1d", "UNetCondAdapter", "UNetNCCA1d", "XUNet1d",
           "create_unet_from_config"]
