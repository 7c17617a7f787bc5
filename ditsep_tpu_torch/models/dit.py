"""Diffusion transformer (DiT) over latent sequences (port of
ditsep_tpu/models/dit.py; reference: stable-audio-tools models/dit.py:
12-428): io projections, Fourier timestep embedding, cross-attention /
prepend / adaLN global conditioning, classifier-free guidance with the
optional std rescale and its interval gate.

Submodules carry the JAX package's flax names (``timestep_features``,
``to_timestep_embed.dense_{0,1}``, ``preprocess_conv``, ``transformer.
layer_{i}...``), so ``models.weights.params_from_jax`` loads its
parameters. The conditioning MLPs exist where the config gives their
width: ``to_cond_embed`` for ``cond_token_dim``, ``to_global_embed`` for
``global_cond_dim``, ``to_prepend_embed`` for ``prepend_cond_dim``.

Input and output are (B, C, T), channel first.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.transformer import (
    ContinuousTransformer, Dense, reset_transformer_parameters,
)

Tensor = torch.Tensor


class FourierFeatures(nn.Module):
    """cat(cos f, sin f) with f = 2 pi x W^T, W (out/2, in) trainable,
    initialised N(0, std^2)."""

    def __init__(self, in_features: int, out_features: int,
                 std: float = 1.0):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(out_features // 2,
                                               in_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.std, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        f = (2 * math.pi * x) @ self.weight.T
        return torch.cat([f.cos(), f.sin()], dim=-1)


class _MLPEmbed(nn.Module):
    """``dense_0`` -> SiLU -> ``dense_1``."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense_0 = Dense(in_dim, out_dim, bias=use_bias, dtype=dtype)
        self.dense_1 = Dense(out_dim, out_dim, bias=use_bias, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.dense_1(F.silu(self.dense_0(x)))


class _Conv1x1(nn.Conv1d):
    """A bias-free 1x1 conv over (B, C, T), zero-initialised, computing in
    ``dtype`` (None: the input's promoted with float32)."""

    def __init__(self, channels_in: int, channels_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(channels_in, channels_out, 1, bias=False)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.zeros_(self.weight)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return F.conv1d(x.to(dt), self.weight.to(dt))


class DiffusionTransformer(nn.Module):
    """The DiT: ``forward(x, t, **conditioning)`` -> the objective's
    prediction, (B, io_channels, T). ``apply_cond_masks=False`` (the
    default) keeps the reference's quirk that no conditioning or padding
    mask reaches attention (every shipped stable-audio checkpoint trained
    that way; ditsep_tpu/models/dit.py:69-78)."""

    def __init__(self, io_channels: int = 32, patch_size: int = 1,
                 embed_dim: int = 768, cond_token_dim: int = 0,
                 project_cond_tokens: bool = True, global_cond_dim: int = 0,
                 project_global_cond: bool = True, input_concat_dim: int = 0,
                 prepend_cond_dim: int = 0, depth: int = 12,
                 num_heads: int = 8, global_cond_type: str = "prepend",
                 diffusion_objective: str = "v", qk_norm: str = "none",
                 sliding_window: Tuple[int, int] = (-1, -1),
                 apply_cond_masks: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if global_cond_type not in ("prepend", "adaLN"):
            raise ValueError(f"unknown global_cond_type {global_cond_type!r}")
        self.io_channels, self.patch_size = io_channels, patch_size
        self.embed_dim, self.cond_token_dim = embed_dim, cond_token_dim
        self.global_cond_type = global_cond_type
        self.diffusion_objective = diffusion_objective
        self.apply_cond_masks = apply_cond_masks
        self.compute_dtype = dtype
        if cond_token_dim > 0:
            self.to_cond_embed = _MLPEmbed(
                cond_token_dim,
                embed_dim if project_cond_tokens else cond_token_dim,
                use_bias=False, dtype=dtype)
        if global_cond_dim > 0:
            self.to_global_embed = _MLPEmbed(
                global_cond_dim,
                embed_dim if project_global_cond else global_cond_dim,
                use_bias=False, dtype=dtype)
        if prepend_cond_dim > 0:
            self.to_prepend_embed = _MLPEmbed(prepend_cond_dim, embed_dim,
                                              use_bias=False, dtype=dtype)
        self.timestep_features = FourierFeatures(1, 256)
        self.to_timestep_embed = _MLPEmbed(256, embed_dim, dtype=dtype)
        dim_in = io_channels + input_concat_dim
        self.preprocess_conv = _Conv1x1(dim_in, dim_in, dtype)
        self.transformer = ContinuousTransformer(
            dim=embed_dim, depth=depth, dim_heads=embed_dim // num_heads,
            dim_in=dim_in * patch_size, dim_out=io_channels * patch_size,
            cross_attend=cond_token_dim > 0,
            cond_token_dim=((embed_dim if project_cond_tokens
                             else cond_token_dim)
                            if cond_token_dim > 0 else None),
            global_cond_dim=embed_dim if global_cond_type == "adaLN"
            else None,
            qk_norm=qk_norm, sliding_window=tuple(sliding_window),
            dtype=dtype)
        self.postprocess_conv = _Conv1x1(io_channels, io_channels, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's initialisers, drawn from ``generator`` in
        module order (zero for the pre/post convs and the branch
        outputs)."""
        reset_transformer_parameters(self, generator)

    def forward(self, x: Tensor, t: Tensor, *,
                cross_attn_cond: Optional[Tensor] = None,
                cross_attn_cond_mask: Optional[Tensor] = None,
                negative_cross_attn_cond: Optional[Tensor] = None,
                negative_cross_attn_mask: Optional[Tensor] = None,
                input_concat_cond: Optional[Tensor] = None,
                global_embed: Optional[Tensor] = None,
                prepend_cond: Optional[Tensor] = None,
                prepend_cond_mask: Optional[Tensor] = None,
                cfg_scale: float = 1.0, cfg_dropout_prob: float = 0.0,
                cfg_interval: Tuple[float, float] = (0.0, 1.0),
                scale_phi: float = 0.0, mask: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None,
                cfg_dropout_uniform: Optional[Tuple[Tensor, Tensor]] = None
                ) -> Tensor:
        """CFG dropout (``cfg_dropout_prob`` > 0) nulls conditioning rows
        whose uniform draw (B, 1, 1) is below the probability, one draw for
        the cross-attention and one for the prepend conditioning, from
        ``generator`` or given as ``cfg_dropout_uniform`` (u_cross,
        u_prepend). CFG (``cfg_scale`` != 1 with cross-attention or
        prepend conditioning) runs the conditioned and the null rows as one
        doubled batch."""
        if cfg_dropout_prob > 0.0:
            if generator is None and cfg_dropout_uniform is None:
                raise ValueError(
                    "cfg_dropout_prob > 0 needs a generator or "
                    "cfg_dropout_uniform: without them conditioning dropout "
                    "would be skipped silently")
            if cfg_dropout_uniform is None:
                cfg_dropout_uniform = tuple(
                    torch.rand((x.shape[0], 1, 1), generator=generator,
                               device=generator.device) for _ in range(2))
            u_cross, u_prep = (u.to(x.device) for u in cfg_dropout_uniform)
            if cross_attn_cond is not None:
                cross_attn_cond = torch.where(
                    u_cross >= cfg_dropout_prob, cross_attn_cond, 0.0)
            if prepend_cond is not None:
                prepend_cond = torch.where(
                    u_prep >= cfg_dropout_prob, prepend_cond, 0.0)

        if cfg_scale != 1.0 and (cross_attn_cond is not None
                                 or prepend_cond is not None):
            def dbl(a):
                return None if a is None else torch.cat([a, a], 0)

            cc = None
            if cross_attn_cond is not None:
                null_cross = torch.zeros_like(cross_attn_cond)
                if negative_cross_attn_cond is not None:
                    null_cross = negative_cross_attn_cond
                    if negative_cross_attn_mask is not None:
                        # masked-out negative tokens take the null embed
                        null_cross = torch.where(
                            negative_cross_attn_mask[..., None].to(
                                torch.bool), null_cross, 0.0)
                cc = torch.cat([cross_attn_cond, null_cross], 0)
            pc = (torch.cat([prepend_cond, torch.zeros_like(prepend_cond)], 0)
                  if prepend_cond is not None else None)
            out = self._forward(
                dbl(x), dbl(t), cross_attn_cond=cc,
                cross_attn_cond_mask=dbl(cross_attn_cond_mask),
                input_concat_cond=dbl(input_concat_cond),
                global_embed=dbl(global_embed), prepend_cond=pc,
                prepend_cond_mask=dbl(prepend_cond_mask), mask=dbl(mask))
            cond_out, uncond_out = out.chunk(2, dim=0)
            cfg_out = uncond_out + (cond_out - uncond_out) * cfg_scale
            if scale_phi != 0.0:
                # the std over the channel axis only (reference:
                # dit.py:404-406)
                cond_std = cond_out.std(dim=1, keepdim=True, correction=0)
                cfg_std = cfg_out.std(dim=1, keepdim=True, correction=0)
                rescaled = cfg_out * (cond_std / cfg_std.clamp_min(1e-8))
                cfg_out = scale_phi * rescaled + (1 - scale_phi) * cfg_out
            # guidance only while sigma(t[0]) lies in the interval: a
            # select on the card, no host round trip
            sigma = (torch.sin(t[0] * math.pi / 2)
                     if self.diffusion_objective == "v" else t[0])
            in_int = (cfg_interval[0] <= sigma) & (sigma <= cfg_interval[1])
            return torch.where(in_int, cfg_out, cond_out)
        return self._forward(
            x, t, cross_attn_cond=cross_attn_cond,
            cross_attn_cond_mask=cross_attn_cond_mask,
            input_concat_cond=input_concat_cond, global_embed=global_embed,
            prepend_cond=prepend_cond, prepend_cond_mask=prepend_cond_mask,
            mask=mask)

    def _forward(self, x, t, *, cross_attn_cond=None,
                 cross_attn_cond_mask=None, input_concat_cond=None,
                 global_embed=None, prepend_cond=None,
                 prepend_cond_mask=None, mask=None):
        if cross_attn_cond is not None:
            cross_attn_cond = self.to_cond_embed(cross_attn_cond)
        if global_embed is not None:
            global_embed = self.to_global_embed(global_embed)

        prepend_inputs = prepend_mask = None
        prepend_length = 0
        if prepend_cond is not None:
            prepend_inputs = self.to_prepend_embed(prepend_cond)
            prepend_mask = prepend_cond_mask

        if input_concat_cond is not None:
            if input_concat_cond.shape[2] != x.shape[2]:
                reps = -(-x.shape[2] // input_concat_cond.shape[2])
                input_concat_cond = torch.repeat_interleave(
                    input_concat_cond, reps, dim=2)[:, :, :x.shape[2]]
            x = torch.cat([x, input_concat_cond.to(x.dtype)], dim=1)

        timestep_embed = self.to_timestep_embed(
            self.timestep_features(t[:, None]))
        global_embed = (timestep_embed if global_embed is None
                        else global_embed + timestep_embed)

        b = x.shape[0]
        ones = lambda n: torch.ones((b, n), dtype=torch.bool,
                                    device=x.device)
        if self.global_cond_type == "prepend":
            ge = global_embed[:, None, :]
            if prepend_inputs is None:
                prepend_inputs, prepend_mask = ge, ones(1)
            else:
                # prepend_cond without a mask is all valid (the reference
                # crashes there)
                if prepend_mask is None:
                    prepend_mask = ones(prepend_inputs.shape[1])
                prepend_inputs = torch.cat([prepend_inputs, ge], 1)
                prepend_mask = torch.cat([prepend_mask.to(torch.bool),
                                          ones(1)], 1)
            prepend_length = prepend_inputs.shape[1]
            adaln_cond = None
        else:
            adaln_cond = global_embed
            if prepend_inputs is not None:
                prepend_length = prepend_inputs.shape[1]

        x = self.preprocess_conv(x) + x
        x = x.transpose(1, 2)  # (B, T, C)
        if self.patch_size > 1:
            bb, tt, c = x.shape
            x = x.reshape(bb, tt // self.patch_size, c * self.patch_size)

        if not self.apply_cond_masks:
            prepend_mask = cross_attn_cond_mask = mask = None
        out = self.transformer(
            x, prepend_embeds=prepend_inputs, prepend_mask=prepend_mask,
            context=cross_attn_cond, context_mask=cross_attn_cond_mask,
            global_cond=adaln_cond, mask=mask)

        if self.patch_size > 1:
            bb, tt, c = out.shape
            out = out.reshape(bb, tt * self.patch_size, c // self.patch_size)
        out = out.transpose(1, 2)
        if prepend_length:  # drop the prepended tokens from the time axis
            out = out[:, :, prepend_length:]
        return self.postprocess_conv(out) + out
