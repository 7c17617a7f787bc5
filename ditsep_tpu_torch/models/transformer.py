"""Continuous transformer stack: RoPE, qk-norm attention, GLU feed-forward,
adaLN global conditioning, sliding-window masks (port of
ditsep_tpu/models/transformer.py; reference: stable-audio-tools
models/transformer.py:28-899).

Submodules carry the JAX package's flax names (``layer_{i}``,
``self_attn.to_qkv``, ``ff.proj_in``, ``pre_norm``...), so its parameters
cross over through ``models.weights.params_from_jax``: a ``Dense`` kernel
(in, out) is a ``weight`` (out, in), a LayerNorm's ``scale`` its
``weight``.

Attention is stock PyTorch, as the JAX package's is plain einsum +
softmax outside any Pallas kernel. Without a mask it is
``F.scaled_dot_product_attention``. With one it is a matmul, the mask
applied as the JAX package does, with ``finfo.min`` and not -inf (a key row
masked in full gives uniform weights, where a boolean SDPA mask gives
NaN), and a softmax in the logits' dtype.

``dtype`` is the compute dtype of the dense layers and the attention, as
the JAX package's field: parameters stay float32 and are cast, with the
input, to ``dtype``; LayerNorm statistics stay float32, as flax's.

The KV cache serves the token LM's decode (models/lm.py):
``ContinuousTransformer.init_cache`` preallocates one (B, H, S_max, Dh)
key and value tensor a layer, a cached call writes its new keys and
values into them in place at ``cache_index`` (a Python int, so the decode
loop never syncs the host) and attends to every slot at or before each
query's position, the rest masked with ``finfo.min`` as in JAX; the RoPE
table spans the whole cache and is sliced at ``cache_index``.

``ConformerModule`` (``conformer=True``) convolves only the tokens of the
call: in a cached decode its 'SAME' depthwise conv and its GroupNorm see
the new token alone, so a cached decode with the conformer differs from
the full pass, in the JAX package as here.

``Conv1d`` is flax's ``nn.Conv`` (explicit, possibly uneven padding) in
torch's NCW layout, with flax's initialiser from a generator, for the
conformer and the 1-D U-Nets; their GroupNorm is ``layers.GroupNorm``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.layers import GroupNorm

Tensor = torch.Tensor

def rotary_freqs(seq_len: int, rot_dim: int, base: float = 10000.0,
                 interpolation_factor: float = 1.0) -> Tensor:
    """(seq, rot_dim) float32 rotary angle table, built in float64 numpy
    as the JAX package builds it (the frequencies repeat over the two
    halves)."""
    inv_freq = 1.0 / (base ** (np.arange(0, rot_dim, 2) / rot_dim))
    t = np.arange(seq_len, dtype=np.float64) / interpolation_factor
    freqs = np.einsum("i,j->ij", t, inv_freq)
    return torch.from_numpy(
        np.concatenate([freqs, freqs], axis=-1).astype(np.float32))


def _rotate_half(x: Tensor) -> Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(t: Tensor, freqs: Tensor) -> Tensor:
    """Partial rotary embedding of t (..., seq, dim_head) by the table
    freqs (seq', rot_dim <= dim_head): its last ``seq`` rows rotate the
    first rot_dim features, the rest pass."""
    rot_dim = freqs.shape[-1]
    freqs = freqs[-t.shape[-2]:]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    # a bf16 head is rotated in float32 and stays float32, as in JAX
    t_rot = t_rot * freqs.cos() + _rotate_half(t_rot) * freqs.sin()
    return torch.cat([t_rot, t_pass.to(t_rot.dtype)], dim=-1)


def sliding_window_mask(q_len: int, k_len: int, window: Tuple[int, int],
                        device=None) -> Optional[Tensor]:
    """Band mask: key j visible to query i iff -window[0] <= j - i <=
    window[1]; -1 leaves a side open, (-1, -1) gives None."""
    left, right = window
    if left == -1 and right == -1:
        return None
    d = (torch.arange(k_len, device=device)[None, :]
         - torch.arange(q_len, device=device)[:, None])
    ok = torch.ones((q_len, k_len), dtype=torch.bool, device=device)
    if left != -1:
        ok = ok & (d >= -left)
    if right != -1:
        ok = ok & (d <= right)
    return ok


def _compute_dtype(x: Tensor, param: Tensor,
                   dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, param.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (None: the promotion of the
    input's and the weight's dtypes, as flax's ``Dense``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 zero_init: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype, self.zero_init = dtype, zero_init

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initialisers: lecun normal (std 1/sqrt(fan_in)), or zeros
        for a zero-initialised output; zero bias."""
        with torch.no_grad():
            if getattr(self, "zero_init", False):
                self.weight.zero_()
            else:
                self.weight.normal_(0.0, self.in_features ** -0.5,
                                    generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        dt = _compute_dtype(x, self.weight, self.compute_dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm``: float32 statistics with the fast variance
    max(E[x^2] - E[x]^2, 0), then (x - mean) * rsqrt(var + eps) * weight +
    bias, in ``dtype`` (None: the input's)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.compute_dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype or x.dtype
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((x32 - mean) * mul + self.bias.float()).to(dt)


class Conv1d(nn.Conv1d):
    """flax's ``nn.Conv`` over NCW: ``padding`` a (left, right) pair (flax's
    explicit padding, which may be uneven), computing in ``dtype``; flax's
    initialisers (lecun normal over fan_in = in / groups x k, zero
    bias)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, *,
                 stride: int = 1, padding: Tuple[int, int] = (0, 0),
                 groups: int = 1, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         groups=groups, bias=bias)
        self.pad, self.compute_dtype = tuple(padding), dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        with torch.no_grad():
            self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        dt = _compute_dtype(x, self.weight, self.compute_dtype)
        left, right = self.pad
        pad = left
        if left != right:
            x, pad = F.pad(x, (left, right)), 0
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv1d(x.to(dt), self.weight.to(dt), b, stride=self.stride,
                        padding=pad, groups=self.groups)


class LayerScale(nn.Module):
    """x * gamma, gamma (dim,) initialised to ones."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.gamma)

    def forward(self, x: Tensor) -> Tensor:
        return x * self.gamma.to(x.dtype)


class FeedForward(nn.Module):
    """SwiGLU feed-forward: ``proj_in`` to 2 x inner (a, gate), a *
    silu(gate), ``proj_out`` (zero-initialised by default); plain SiLU with
    ``glu=False``."""

    def __init__(self, dim: int, dim_out: Optional[int] = None,
                 mult: float = 4.0, no_bias: bool = False, glu: bool = True,
                 zero_init_output: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = int(dim * mult)
        self.glu = glu
        self.proj_in = Dense(dim, inner * 2 if glu else inner,
                             bias=not no_bias, dtype=dtype)
        self.proj_out = Dense(inner, dim_out or dim, bias=not no_bias,
                              dtype=dtype, zero_init=zero_init_output)

    def forward(self, x: Tensor) -> Tensor:
        h = self.proj_in(x)
        if self.glu:
            a, gate = h.chunk(2, dim=-1)
            h = a * F.silu(gate)
        else:
            h = F.silu(h)
        return self.proj_out(h)


class Attention(nn.Module):
    """Multi-head attention with optional qk-norm ('ln' or 'l2'), RoPE,
    causal and sliding-window masks, a key-padding mask and
    cross-attention (``dim_context``: K / V projected from the context to
    the query width, as the JAX package does)."""

    def __init__(self, dim: int, dim_heads: int = 64,
                 dim_context: Optional[int] = None,
                 dim_out: Optional[int] = None, causal: bool = False,
                 zero_init_output: bool = True, qk_norm: str = "none",
                 sliding_window: Tuple[int, int] = (-1, -1),
                 dtype: Optional[torch.dtype] = None,
                 dim_in: Optional[int] = None):
        super().__init__()
        self.dim, self.dim_heads = dim, dim_heads
        self.cross = dim_context is not None
        self.causal, self.qk_norm = causal, qk_norm
        self.sliding_window = tuple(sliding_window)
        self.compute_dtype = dtype
        dim_in = dim_in or dim  # the query input's width (flax infers it)
        if self.cross:
            self.to_q = Dense(dim_in, dim, bias=False, dtype=dtype)
            self.to_kv = Dense(dim_context, dim * 2, bias=False, dtype=dtype)
        else:
            self.to_qkv = Dense(dim_in, dim * 3, bias=False, dtype=dtype)
        if qk_norm == "ln":
            self.q_norm = LayerNorm(dim_heads, 1e-6, dtype)
            self.k_norm = LayerNorm(dim_heads, 1e-6, dtype)
        elif qk_norm not in ("none", "l2"):
            raise ValueError(f"unknown qk_norm {qk_norm!r}")
        self.to_out = Dense(dim, dim_out or dim, bias=False, dtype=dtype,
                            zero_init=zero_init_output)

    def forward(self, x: Tensor, context: Optional[Tensor] = None,
                mask: Optional[Tensor] = None,
                rotary_pos_emb: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None,
                cache_index: Optional[int] = None):
        """The attended output; with ``cache`` (the layer's (k, v), each
        (B, H, S_max, Dh)) and ``cache_index`` (the absolute position of
        x's first token, an int), an incremental decode: x's keys and
        values are written into the cache in place, and (out, cache)
        returns."""
        if self.cross:
            q = self.to_q(x)
            k, v = self.to_kv(context).chunk(2, dim=-1)
        else:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)

        def split_heads(t):
            b, n, _ = t.shape
            return t.reshape(b, n, -1, self.dim_heads).transpose(1, 2)

        q, k, v = map(split_heads, (q, k, v))
        if self.qk_norm == "ln":
            q, k = self.q_norm(q), self.k_norm(k)
        elif self.qk_norm == "l2":
            q = q / torch.linalg.vector_norm(q, dim=-1,
                                             keepdim=True).clamp_min(1e-12)
            k = k / torch.linalg.vector_norm(k, dim=-1,
                                             keepdim=True).clamp_min(1e-12)
        if cache is not None:
            return self._cached(x, q, k, v, rotary_pos_emb, cache,
                                cache_index)
        if rotary_pos_emb is not None and not self.cross:
            q = apply_rotary_pos_emb(q, rotary_pos_emb)
            k = apply_rotary_pos_emb(k, rotary_pos_emb)

        qn, kn = q.shape[-2], k.shape[-2]
        keep = None
        if self.causal:
            keep = torch.ones((qn, kn), dtype=torch.bool,
                              device=q.device).tril(kn - qn)
        band = sliding_window_mask(qn, kn, self.sliding_window, q.device)
        if band is not None:
            keep = band if keep is None else keep & band
        if mask is not None:  # (B, k) key padding mask
            pad = mask.to(torch.bool)[:, None, None, :]
            keep = pad if keep is None else keep & pad
        scale = self.dim_heads ** -0.5
        v = v.to(q.dtype)
        if keep is None:
            out = F.scaled_dot_product_attention(q, k, v, scale=scale)
        else:
            logits = torch.matmul(q, k.transpose(-1, -2)) * scale
            logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
            out = torch.matmul(logits.softmax(dim=-1), v)
        out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        out = self.to_out(out)
        if mask is not None and not self.cross:
            # self-attention also zeroes the output at masked query
            # positions (reference: transformer.py:594-596)
            out = out.masked_fill(~mask.to(torch.bool)[:, :, None], 0.0)
        return out

    def _cached(self, x, q, k, v, rotary_pos_emb, cache, cache_index: int):
        if self.cross or cache_index is None:
            raise ValueError("the KV cache is for self-attention and needs "
                             "cache_index")
        qn = q.shape[2]
        if rotary_pos_emb is not None:
            # the table spans the cache: the rows at the new positions
            freqs = rotary_pos_emb[cache_index:cache_index + qn]
            q = apply_rotary_pos_emb(q, freqs)
            k = apply_rotary_pos_emb(k, freqs)
        k_cache, v_cache = cache
        k_cache[:, :, cache_index:cache_index + qn] = k.to(k_cache.dtype)
        v_cache[:, :, cache_index:cache_index + qn] = v.to(v_cache.dtype)
        logits = torch.matmul(q, k_cache.to(q.dtype).transpose(-1, -2)) * (
            self.dim_heads ** -0.5)
        qpos = cache_index + torch.arange(qn, device=q.device)[:, None]
        kpos = torch.arange(k_cache.shape[2], device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, torch.finfo(logits.dtype).min)
        out = torch.matmul(logits.softmax(dim=-1), v_cache.to(logits.dtype))
        out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        return self.to_out(out), (k_cache, v_cache)


class ConformerModule(nn.Module):
    """The conformer conv block over (B, T, C): LayerNorm, ``pointwise_1``,
    a GLU (``glu``: a * sigmoid(gate)), a 17-tap depthwise conv with
    'SAME' padding, GroupNorm(1) over (T, C), SiLU, ``pointwise_2``. Only
    the tokens of the call enter the conv and the norm."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_norm = LayerNorm(dim, 1e-6, dtype)
        self.pointwise_1 = Dense(dim, dim, dtype=dtype)
        self.glu = Dense(dim, 2 * dim, dtype=dtype)
        self.depthwise = Conv1d(dim, dim, 17, padding=(8, 8), groups=dim,
                                dtype=dtype)
        self.mid_norm = GroupNorm(1, dim, 1e-6, dtype)
        self.pointwise_2 = Dense(dim, dim, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        a, gate = self.glu(self.pointwise_1(self.in_norm(x))).chunk(2, -1)
        h = self.depthwise((a * torch.sigmoid(gate)).transpose(1, 2))
        return self.pointwise_2(F.silu(self.mid_norm(h)).transpose(1, 2))


class TransformerBlock(nn.Module):
    """Pre-norm block: self-attention, optional cross-attention,
    feed-forward; with ``global_cond_dim``, adaLN: a learned
    ``to_scale_shift_gate`` (6 x dim) plus the global conditioning gives
    the scale, shift and sigmoid(1 - gate) of the self-attention and
    feed-forward branches."""

    def __init__(self, dim: int, dim_heads: int = 64,
                 cross_attend: bool = False,
                 dim_context: Optional[int] = None,
                 global_cond_dim: Optional[int] = None,
                 causal: bool = False, zero_init_branch_outputs: bool = True,
                 conformer: bool = False, remove_norms: bool = False,
                 layer_scale: bool = False, qk_norm: str = "none",
                 sliding_window: Tuple[int, int] = (-1, -1),
                 ff_mult: float = 4.0, norm_eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        zero_init = zero_init_branch_outputs and not layer_scale
        self.dim, self.cross_attend = dim, cross_attend
        self.adaln = bool(global_cond_dim)

        def norm():
            return nn.Identity() if remove_norms else LayerNorm(
                dim, norm_eps, dtype)

        def scale():
            return LayerScale(dim) if layer_scale else nn.Identity()

        self.pre_norm, self.ff_norm = norm(), norm()
        self.self_attn = Attention(
            dim, dim_heads=dim_heads, causal=causal,
            zero_init_output=zero_init, qk_norm=qk_norm,
            sliding_window=sliding_window, dtype=dtype)
        self.self_attn_scale = scale()
        if cross_attend:
            self.cross_attend_norm = norm()
            self.cross_attn = Attention(
                dim, dim_heads=dim_heads, dim_context=dim_context or dim,
                zero_init_output=zero_init, qk_norm=qk_norm, dtype=dtype)
            self.cross_attn_scale = scale()
        self.conformer = ConformerModule(dim, dtype) if conformer else None
        if conformer:
            self.conformer_scale = scale()
        self.ff = FeedForward(dim, mult=ff_mult, zero_init_output=zero_init,
                              dtype=dtype)
        self.ff_scale = scale()
        if self.adaln:
            self.to_scale_shift_gate = nn.Parameter(torch.zeros(6 * dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.adaln:
            with torch.no_grad():
                self.to_scale_shift_gate.normal_(0.0, self.dim ** -0.5,
                                                 generator=generator)

    def _cross_conformer(self, x, context, context_mask):
        if context is not None and self.cross_attend:
            x = x + self.cross_attn_scale(self.cross_attn(
                self.cross_attend_norm(x), context=context,
                mask=context_mask))
        if self.conformer is not None:
            x = x + self.conformer_scale(self.conformer(x))
        return x

    def forward(self, x: Tensor, context: Optional[Tensor] = None,
                global_cond: Optional[Tensor] = None,
                mask: Optional[Tensor] = None,
                context_mask: Optional[Tensor] = None,
                rotary_pos_emb: Optional[Tensor] = None,
                cache: Optional[Tuple[Tensor, Tensor]] = None,
                cache_index: Optional[int] = None):
        """x (B, T, dim) -> (B, T, dim); with ``cache`` (this layer's (k,
        v)) an incremental decode at ``cache_index`` (no key mask), which
        returns (x, cache)."""
        new_cache = None

        def self_attn(h):
            nonlocal new_cache
            if cache is None:
                return self.self_attn(h, mask=mask,
                                      rotary_pos_emb=rotary_pos_emb)
            h, new_cache = self.self_attn(h, rotary_pos_emb=rotary_pos_emb,
                                          cache=cache,
                                          cache_index=cache_index)
            return h

        if self.adaln and global_cond is not None:
            ssg = (self.to_scale_shift_gate + global_cond)[:, None, :]
            (scale_self, shift_self, gate_self, scale_ff, shift_ff,
             gate_ff) = ssg.chunk(6, dim=-1)
            h = self_attn(self.pre_norm(x) * (1 + scale_self) + shift_self)
            x = x + self.self_attn_scale(h * torch.sigmoid(1 - gate_self))
            x = self._cross_conformer(x, context, context_mask)
            h = self.ff(self.ff_norm(x) * (1 + scale_ff) + shift_ff)
            x = x + self.ff_scale(h * torch.sigmoid(1 - gate_ff))
        else:
            x = x + self.self_attn_scale(self_attn(self.pre_norm(x)))
            x = self._cross_conformer(x, context, context_mask)
            x = x + self.ff_scale(self.ff(self.ff_norm(x)))
        return x if cache is None else (x, new_cache)


class ContinuousTransformer(nn.Module):
    """A stack of ``TransformerBlock``s over (B, T, C) with optional
    ``project_in`` / ``project_out`` (no bias), prepended embeddings,
    RoPE over min(max(dim_heads / 2, 32), dim_heads) features of each
    head, and an adaLN global conditioning MLP (``global_embed_in`` ->
    SiLU -> ``global_embed_out`` to 6 x dim)."""

    def __init__(self, dim: int, depth: int, dim_in: Optional[int] = None,
                 dim_out: Optional[int] = None, dim_heads: int = 64,
                 cross_attend: bool = False,
                 cond_token_dim: Optional[int] = None,
                 final_cross_attn_ix: int = -1,
                 global_cond_dim: Optional[int] = None,
                 causal: bool = False, rotary_pos_emb: bool = True,
                 zero_init_branch_outputs: bool = True,
                 conformer: bool = False, qk_norm: str = "none",
                 sliding_window: Tuple[int, int] = (-1, -1),
                 ff_mult: float = 4.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.depth, self.dim_heads = dim, depth, dim_heads
        self.rotary = rotary_pos_emb
        self.global_cond_dim = global_cond_dim
        self._rope_cache = {}
        if dim_in is not None:
            self.project_in = Dense(dim_in, dim, bias=False, dtype=dtype)
        if global_cond_dim:
            self.global_embed_in = Dense(global_cond_dim, dim, dtype=dtype)
            self.global_embed_out = Dense(dim, dim * 6, dtype=dtype)
        for i in range(depth):
            self.add_module(f"layer_{i}", TransformerBlock(
                dim, dim_heads=dim_heads,
                cross_attend=cross_attend and (final_cross_attn_ix == -1
                                               or i <= final_cross_attn_ix),
                dim_context=cond_token_dim, global_cond_dim=global_cond_dim,
                causal=causal,
                zero_init_branch_outputs=zero_init_branch_outputs,
                conformer=conformer, qk_norm=qk_norm,
                sliding_window=sliding_window, ff_mult=ff_mult, dtype=dtype))
        if dim_out is not None:
            self.project_out = Dense(dim, dim_out, bias=False, dtype=dtype)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> Tuple:
        """Per-layer (k, v) caches of ``max_len`` positions, zeros of (B,
        H, max_len, Dh), allocated once (on the parameters' device by
        default); a cached call writes into them in place."""
        if device is None:
            device = next(self.parameters()).device
        shape = (batch, self.dim // self.dim_heads, max_len, self.dim_heads)
        return tuple((torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))
                     for _ in range(self.depth))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.depth)]

    def rope(self, seq: int, device) -> Tensor:
        rot_dim = min(max(self.dim_heads // 2, 32), self.dim_heads)
        key = (seq, rot_dim, str(device))
        if key not in self._rope_cache:
            self._rope_cache[key] = rotary_freqs(seq, rot_dim).to(device)
        return self._rope_cache[key]

    def forward(self, x: Tensor, mask: Optional[Tensor] = None,
                prepend_embeds: Optional[Tensor] = None,
                prepend_mask: Optional[Tensor] = None,
                global_cond: Optional[Tensor] = None,
                context: Optional[Tensor] = None,
                context_mask: Optional[Tensor] = None,
                return_info: bool = False, cache: Optional[Tuple] = None,
                cache_index: Optional[int] = None):
        """(B, T, dim_in) -> (B, T', dim_out) (with ``return_info`` also
        each layer's hidden states); with ``cache`` (``init_cache``'s) and
        ``cache_index`` an incremental decode, which returns (x,
        caches)."""
        batch, seq = x.shape[:2]
        if hasattr(self, "project_in"):
            x = self.project_in(x)
        if prepend_embeds is not None:
            if prepend_embeds.shape[-1] != x.shape[-1]:
                raise ValueError("prepend_embeds must have the model width")
            plen = prepend_embeds.shape[1]
            x = torch.cat([prepend_embeds.to(x.dtype), x], dim=1)
            if prepend_mask is not None or mask is not None:
                ones = lambda n: torch.ones((batch, n), dtype=torch.bool,
                                            device=x.device)
                mask = torch.cat([
                    ones(plen) if prepend_mask is None
                    else prepend_mask.to(torch.bool),
                    ones(seq) if mask is None else mask.to(torch.bool)],
                    dim=-1)
        # decode: the table spans the absolute cache positions
        rope_len = x.shape[1] if cache is None else cache[0][0].shape[2]
        rope = self.rope(rope_len, x.device) if self.rotary else None
        if global_cond is not None and self.global_cond_dim:
            global_cond = self.global_embed_out(F.silu(
                self.global_embed_in(global_cond)))
        else:
            global_cond = None
        info = {"hidden_states": []}
        new_caches = []
        for i, block in enumerate(self.layers()):
            if cache is not None:
                x, c = block(x, context=context, global_cond=global_cond,
                             context_mask=context_mask, rotary_pos_emb=rope,
                             cache=cache[i], cache_index=cache_index)
                new_caches.append(c)
            else:
                x = block(x, context=context, global_cond=global_cond,
                          mask=mask, context_mask=context_mask,
                          rotary_pos_emb=rope)
            if return_info:
                info["hidden_states"].append(x)
        if hasattr(self, "project_out"):
            x = self.project_out(x)
        if cache is not None:
            return x, tuple(new_caches)
        return (x, info) if return_info else x


def reset_transformer_parameters(module: nn.Module,
                                 generator: Optional[torch.Generator] = None
                                 ) -> None:
    """(Re)initialise every submodule of ``module`` that has
    ``reset_parameters``, in module order, from ``generator`` (a nested
    ``Seeded`` module's leaves once, through this walk)."""
    for m in module.modules():
        if (m is not module and not isinstance(m, Seeded)
                and hasattr(m, "reset_parameters")):
            m.reset_parameters(generator)


class Seeded(nn.Module):
    """A module whose ``reset_parameters(generator)`` re-initialises every
    submodule (``reset_transformer_parameters``)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_transformer_parameters(self, generator)


__all__ = ["Attention", "ConformerModule", "ContinuousTransformer", "Conv1d",
           "Dense", "FeedForward", "LayerNorm", "LayerScale",
           "Seeded", "TransformerBlock",
           "apply_rotary_pos_emb", "reset_transformer_parameters",
           "rotary_freqs", "sliding_window_mask"]
