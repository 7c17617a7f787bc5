"""The audio language model over residual-VQ token grids (port of
ditsep_tpu/models/lm.py; reference: stable-audio-tools models/lm.py,
lm_backbone.py, codebook_patterns.py): the codebook patterns, a causal
``ContinuousTransformer`` with cross-attention, prepend and global
conditioning, per-codebook embeddings and heads, and KV-cached generation
(one prefill, then single-token decode steps over a preallocated cache)
with temperature / top-k / top-p sampling and classifier-free guidance.

Sampling is Gumbel-max, as ``jax.random.categorical`` is: the token is the
argmax of the (masked) logits plus standard Gumbel noise.
``lm_generate`` takes that noise as ``gumbel`` (one (B, n_q, codebook_size)
draw a step, the JAX package's per-step key split), or draws it from a
``generator``. Tokens are int64 (``torch.long``) where JAX's are int32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.transformer import (
    ContinuousTransformer, Dense, Seeded,
)

Tensor = torch.Tensor


def _full_like_grid(tokens: Tensor, shape, fill: int) -> Tensor:
    return torch.full(shape, fill, dtype=tokens.dtype, device=tokens.device)


@dataclasses.dataclass(frozen=True)
class DelayPattern:
    """MusicGen's delay pattern: codebook q is shifted right by q steps."""

    n_q: int
    special_token: int

    @property
    def extra_steps(self) -> int:
        return self.n_q - 1

    def apply(self, tokens: Tensor) -> Tensor:
        """(B, n_q, T) -> (B, n_q, T + n_q - 1) delayed layout."""
        b, n_q, t = tokens.shape
        out = _full_like_grid(tokens, (b, n_q, t + self.extra_steps),
                              self.special_token)
        for q in range(n_q):
            out[:, q, q:q + t] = tokens[:, q]
        return out

    def revert(self, delayed: Tensor) -> Tensor:
        """(B, n_q, T + n_q - 1) -> (B, n_q, T)."""
        t = delayed.shape[-1] - self.extra_steps
        return torch.stack([delayed[:, q, q:q + t]
                            for q in range(delayed.shape[1])], dim=1)


@dataclasses.dataclass(frozen=True)
class ParallelPattern:
    """Every codebook predicted at the same step."""

    n_q: int
    special_token: int

    @property
    def extra_steps(self) -> int:
        return 0

    def apply(self, tokens: Tensor) -> Tensor:
        return tokens

    def revert(self, delayed: Tensor) -> Tensor:
        return delayed


@dataclasses.dataclass(frozen=True)
class CustomDelayPattern:
    """A delay pattern with given, non-decreasing per-codebook delays
    (default 0, 1, ..., n_q - 1)."""

    n_q: int
    special_token: int
    delays: tuple = ()

    def __post_init__(self):
        d = self.delays or tuple(range(self.n_q))
        if len(d) != self.n_q or tuple(sorted(d)) != tuple(d):
            raise ValueError(f"delays {d} must be n_q non-decreasing values")
        object.__setattr__(self, "delays", tuple(d))

    @property
    def extra_steps(self) -> int:
        return max(self.delays)

    def apply(self, tokens: Tensor) -> Tensor:
        b, n_q, t = tokens.shape
        out = _full_like_grid(tokens, (b, n_q, t + self.extra_steps),
                              self.special_token)
        for q, d in enumerate(self.delays):
            out[:, q, d:d + t] = tokens[:, q]
        return out

    def revert(self, delayed: Tensor) -> Tensor:
        t = delayed.shape[-1] - self.extra_steps
        return torch.stack([delayed[:, q, d:d + t]
                            for q, d in enumerate(self.delays)], dim=1)


@dataclasses.dataclass(frozen=True)
class CoarseFirstPattern:
    """All of codebook 0 first, then the other codebooks (each with an
    optional delay): a grid of 2 T + max(delays) steps."""

    n_q: int
    special_token: int
    delays: tuple = ()

    def __post_init__(self):
        d = self.delays or tuple([0] * (self.n_q - 1))
        if len(d) != self.n_q - 1:
            raise ValueError(f"delays {d} must have n_q - 1 values")
        object.__setattr__(self, "delays", tuple(d))

    def seq_len(self, t: int) -> int:
        return 2 * t + (max(self.delays) if self.delays else 0)

    @property
    def extra_steps(self) -> int:
        raise NotImplementedError("use seq_len(); S depends on T")

    def apply(self, tokens: Tensor) -> Tensor:
        b, n_q, t = tokens.shape
        out = _full_like_grid(tokens, (b, n_q, self.seq_len(t)),
                              self.special_token)
        out[:, 0, :t] = tokens[:, 0]
        for q, d in enumerate(self.delays):
            out[:, q + 1, t + d:t + d + t] = tokens[:, q + 1]
        return out

    def revert(self, grid: Tensor) -> Tensor:
        max_d = max(self.delays) if self.delays else 0
        t = (grid.shape[-1] - max_d) // 2
        rows = [grid[:, 0, :t]]
        for q, d in enumerate(self.delays):
            rows.append(grid[:, q + 1, t + d:t + d + t])
        return torch.stack(rows, dim=1)


@dataclasses.dataclass(frozen=True)
class UnrolledPattern:
    """The unrolled (flattened) pattern: each timestep expands into
    ``n_inner`` sequence steps, codebook q emitted at inner step
    ``flattening[q]``, with optional per-codebook ``delays`` (codebooks on
    one inner step share a delay); the sequence starts with one empty
    step. The layout is built on the host for each length."""

    n_q: int
    special_token: int
    flattening: tuple = ()
    delays: tuple = ()

    def __post_init__(self):
        f = self.flattening or tuple(range(self.n_q))
        d = self.delays or tuple([0] * self.n_q)
        for name, v in (("flattening", f), ("delays", d)):
            if len(v) != self.n_q or tuple(sorted(v)) != tuple(v):
                raise ValueError(f"{name} {v} must be n_q non-decreasing "
                                 "values")
        step_delay = {}
        for st, dq in zip(f, d):
            if step_delay.setdefault(st, dq) != dq:
                raise ValueError("codebooks flattened to the same inner step "
                                 "must share a delay")
        object.__setattr__(self, "flattening", tuple(f))
        object.__setattr__(self, "delays", tuple(d))

    @property
    def n_inner(self) -> int:
        return max(self.flattening) + 1

    @property
    def max_delay(self) -> int:
        return max(self.delays)

    def _layout(self, t: int):
        """Entry s lists the (timestep, codebook) coordinates emitted at
        sequence step s: each inner step of timestep t0 keyed by t0 +
        delay, stably sorted."""
        step_cbs = {}
        for q, st in enumerate(self.flattening):
            step_cbs.setdefault(st, []).append(q)
        max_t = t + self.max_delay
        indexed = [(-1, [])]
        for t0 in range(max_t):
            for st in range(self.n_inner):
                if st in step_cbs:
                    qs = step_cbs[st]
                    t_for_q = t0 + self.delays[qs[0]]
                    if t_for_q < max_t:
                        indexed.append((t_for_q, [(t0, q) for q in qs]))
                else:
                    indexed.append((t0, []))
        return [coords for _, coords in sorted(indexed)]

    def seq_len(self, t: int) -> int:
        if self.max_delay == 0:
            return 1 + t * self.n_inner
        return len(self._layout(t))

    def _timesteps_for_seq(self, s: int) -> int:
        if self.max_delay == 0:
            return (s - 1) // self.n_inner
        t = max(0, (s - 1) // self.n_inner - self.max_delay)
        while self.seq_len(t) < s:
            t += 1
        if self.seq_len(t) != s:
            raise ValueError(f"a grid of {s} steps matches no timestep count")
        return t

    def _scatter_indices(self, t: int):
        s_idx, q_idx, t_idx = [], [], []
        for s, coords in enumerate(self._layout(t)):
            for (t0, q) in coords:
                if t0 < t:
                    s_idx.append(s)
                    q_idx.append(q)
                    t_idx.append(t0)
        return (torch.as_tensor(s_idx, dtype=torch.long),
                torch.as_tensor(q_idx, dtype=torch.long),
                torch.as_tensor(t_idx, dtype=torch.long))

    def apply(self, tokens: Tensor) -> Tensor:
        b, n_q, t = tokens.shape
        s_idx, q_idx, t_idx = (i.to(tokens.device)
                               for i in self._scatter_indices(t))
        out = _full_like_grid(tokens, (b, n_q, self.seq_len(t)),
                              self.special_token)
        out[:, q_idx, s_idx] = tokens[:, q_idx, t_idx]
        return out

    def revert(self, grid: Tensor) -> Tensor:
        b, n_q, s = grid.shape
        t = self._timesteps_for_seq(s)
        s_idx, q_idx, t_idx = (i.to(grid.device)
                               for i in self._scatter_indices(t))
        out = _full_like_grid(grid, (b, n_q, t), self.special_token)
        out[:, q_idx, t_idx] = grid[:, q_idx, s_idx]
        return out


@dataclasses.dataclass(frozen=True)
class MusicLMPattern:
    """Codebook groups of ``group_by`` generated one after the other, each
    group flattened over time."""

    n_q: int
    special_token: int
    group_by: int = 2

    def seq_len(self, t: int) -> int:
        return self.n_q * t

    def _positions(self, t: int, device):
        for offset in range(0, self.n_q, self.group_by):
            for j in range(self.group_by):
                yield offset + j, (offset * t + j + self.group_by
                                   * torch.arange(t, device=device))

    def apply(self, tokens: Tensor) -> Tensor:
        b, n_q, t = tokens.shape
        out = _full_like_grid(tokens, (b, n_q, n_q * t), self.special_token)
        for q, pos in self._positions(t, tokens.device):
            out[:, q, pos] = tokens[:, q]
        return out

    def revert(self, grid: Tensor) -> Tensor:
        t = grid.shape[-1] // grid.shape[1]
        return torch.stack([grid[:, q, pos] for q, pos
                            in self._positions(t, grid.device)], dim=1)


class Embed(nn.Embedding):
    """flax's ``nn.Embed`` (its table the ``embedding`` leaf): initialised
    N(0, 1 / features) from a generator."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.embedding_dim ** -0.5,
                                generator=generator)


class AudioLM(Seeded):
    """A causal LM over (B, n_q, S) token grids (the pattern's layout) with
    optional cross-attention tokens, prepended embeddings
    (``prepend_proj``) and a global vector: ``emb_{q}`` summed over the
    codebooks, the ``backbone``, ``head_{q}`` a codebook. The same
    parameters serve the full pass and the cached decode."""

    def __init__(self, n_quantizers: int = 4, codebook_size: int = 1024,
                 dim: int = 256, depth: int = 4, num_heads: int = 4,
                 cross_attn_cond_dim: int = 0, prepend_cond_dim: int = 0,
                 global_cond_dim: int = 0, conformer: bool = False,
                 backbone_kwargs: Optional[dict] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_quantizers, self.codebook_size = n_quantizers, codebook_size
        self.dim, self.depth, self.num_heads = dim, depth, num_heads
        self.backbone = ContinuousTransformer(
            dim, depth, dim_heads=dim // num_heads, causal=True,
            cross_attend=cross_attn_cond_dim > 0,
            cond_token_dim=cross_attn_cond_dim or None,
            global_cond_dim=global_cond_dim or None, conformer=conformer,
            dtype=dtype, **dict(backbone_kwargs or {}))
        for q in range(n_quantizers):
            self.add_module(f"emb_{q}", Embed(codebook_size + 1, dim))
        for q in range(n_quantizers):
            self.add_module(f"head_{q}", Dense(dim, codebook_size,
                                               dtype=dtype))
        if prepend_cond_dim:
            self.prepend_proj = Dense(prepend_cond_dim, dim, dtype=dtype)

    @property
    def special_token(self) -> int:
        return self.codebook_size  # the extra id: pattern padding and BOS

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        """The backbone's KV caches for ``max_len`` positions (prepended
        tokens and generated steps)."""
        return self.backbone.init_cache(batch, max_len, dtype)

    def _embed(self, tokens: Tensor) -> Tensor:
        return sum(getattr(self, f"emb_{q}")(tokens[:, q])
                   for q in range(self.n_quantizers))

    def _heads(self, h: Tensor) -> Tensor:
        return torch.stack([getattr(self, f"head_{q}")(h)
                            for q in range(self.n_quantizers)], dim=1)

    def _prepend(self, prepend_cond: Optional[Tensor]) -> Optional[Tensor]:
        return None if prepend_cond is None else self.prepend_proj(
            prepend_cond)

    def forward(self, tokens: Tensor,
                cross_attn_cond: Optional[Tensor] = None,
                cross_attn_mask: Optional[Tensor] = None,
                prepend_cond: Optional[Tensor] = None,
                global_cond: Optional[Tensor] = None,
                cache: Optional[tuple] = None,
                cache_index: Optional[int] = None):
        """Full pass: tokens (B, n_q, S) -> logits (B, n_q, S,
        codebook_size), position s seeing s' <= s and the prepended
        conditioning. With ``cache`` / ``cache_index``: the decode of the
        tokens at absolute positions cache_index.., returning (logits,
        cache); pass ``prepend_cond`` on the prefill only (its embeddings
        take the first cache slots)."""
        n_prep = 0 if prepend_cond is None else prepend_cond.shape[1]
        if cache is not None:
            x = self._embed(tokens)
            if n_prep:
                x = torch.cat([self._prepend(prepend_cond).to(x.dtype), x],
                              dim=1)
            h, cache = self.backbone(
                x, context=cross_attn_cond, context_mask=cross_attn_mask,
                global_cond=global_cond, cache=cache,
                cache_index=cache_index)
            return self._heads(h[:, n_prep:]), cache
        h = self.backbone(self._embed(tokens),
                          prepend_embeds=self._prepend(prepend_cond),
                          context=cross_attn_cond,
                          context_mask=cross_attn_mask,
                          global_cond=global_cond)
        return self._heads(h[:, n_prep:])


def lm_loss(model: AudioLM, tokens: Tensor, pattern=None) -> Tensor:
    """Next-step cross-entropy in the pattern's layout (BOS + the grid
    but its last step in, the grid out), the pattern's padding masked."""
    pattern = pattern or DelayPattern(model.n_quantizers,
                                      model.special_token)
    delayed = pattern.apply(tokens)
    bos = torch.full(delayed.shape[:2] + (1,), model.special_token,
                     dtype=delayed.dtype, device=delayed.device)
    logits = model(torch.cat([bos, delayed[..., :-1]], dim=-1))
    valid = (delayed != model.special_token).to(logits.dtype)
    logp = F.log_softmax(logits, dim=-1)
    tgt = delayed.clamp(0, model.codebook_size - 1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


def _mask_top_k(logits: Tensor, k: int) -> Tensor:
    """Every logit below the k-th largest to -inf (ties at it kept)."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, float("-inf"))


def _mask_top_p(logits: Tensor, p: float) -> Tensor:
    """Nucleus filtering: the smallest prefix of the distribution sorted
    by falling logit whose mass reaches p. The sort is stable, as
    ``jnp.argsort``, so tied logits keep their order; the exclusive prefix
    mass (cum - probs) < p keeps the first token always."""
    neg_sorted, sort_idx = torch.sort(-logits, dim=-1, stable=True)
    probs = torch.softmax(-neg_sorted, dim=-1)
    keep_sorted = (probs.cumsum(dim=-1) - probs) < p
    keep = torch.empty_like(keep_sorted).scatter_(-1, sort_idx, keep_sorted)
    return logits.masked_fill(~keep, float("-inf"))


def gumbel_noise(shape, generator: torch.Generator, device=None,
                 dtype=torch.float32) -> Tensor:
    """Standard Gumbel draws -log(-log(u)), u uniform on [tiny, 1), as
    ``jax.random.gumbel`` forms them."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=device or generator.device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def _sample_tokens(logits: Tensor, temperature: float, top_k: int,
                   top_p: float, gumbel: Optional[Tensor] = None) -> Tensor:
    """Temperature, then top-p (if > 0) or top-k (if > 0) masking, then
    the Gumbel-max draw with ``gumbel`` (the logits' shape); temperature
    <= 0 is the greedy argmax."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_p > 0.0:
        logits = _mask_top_p(logits, top_p)
    elif top_k > 0:
        logits = _mask_top_k(logits, min(top_k, logits.shape[-1]))
    return (logits + gumbel.to(logits)).argmax(dim=-1)


def _pattern_steps(pattern, length: int) -> int:
    if hasattr(pattern, "seq_len"):
        return pattern.seq_len(length)
    return length + pattern.extra_steps


def _pattern_valid_mask(pattern, batch: int, length: int,
                        device=None) -> Tensor:
    """(B, n_q, S) mask of the grid positions that carry real tokens: a
    marker grid of (1, n_q, length) laid out by the pattern's own
    ``apply``, every position still holding the special token invalid."""
    marker = pattern.special_token - 1
    grid = torch.full((1, pattern.n_q, length), marker, dtype=torch.long,
                      device=device)
    valid = pattern.apply(grid) == marker
    return valid.expand((batch,) + valid.shape[1:])


@torch.no_grad()
def lm_generate(model: AudioLM, batch: int, length: int, *,
                temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
                cfg_scale: float = 1.0,
                cross_attn_cond: Optional[Tensor] = None,
                cross_attn_mask: Optional[Tensor] = None,
                prepend_cond: Optional[Tensor] = None,
                global_cond: Optional[Tensor] = None,
                pattern=None, generator: Optional[torch.Generator] = None,
                gumbel: Optional[Sequence[Tensor]] = None) -> Tensor:
    """KV-cached sampling: one prefill of the prepended conditioning and
    BOS, then a Python loop of single-token steps over one preallocated
    cache (``n_prep + steps + 1`` positions, ``cache_index`` a Python
    int). With CFG (``cfg_scale`` != 1 and some conditioning) the batch
    doubles with the conditioning zeroed in its second half, and the
    logits blend uncond + (cond - uncond) * cfg_scale. The draws: step i
    takes ``gumbel[i]`` (B, n_q, codebook_size), or fresh ones from
    ``generator``. A sampled token feeds the next step as it is; the
    pattern's invalid positions become the special token at the end.
    Returns (B, n_q, length) tokens in the canonical layout."""
    if temperature > 0 and gumbel is None and generator is None:
        raise ValueError("sampling needs its draws: pass generator= or "
                         "gumbel=")
    pattern = pattern or DelayPattern(model.n_quantizers,
                                      model.special_token)
    steps = _pattern_steps(pattern, length)
    n_q = model.n_quantizers
    device = next(model.parameters()).device
    n_prep = 0 if prepend_cond is None else prepend_cond.shape[1]
    use_cfg = cfg_scale != 1.0 and any(
        c is not None for c in (cross_attn_cond, prepend_cond, global_cond))

    def dup(a):
        return None if a is None else torch.cat([a, a], dim=0)

    def null_pair(a):
        return None if a is None else torch.cat([a, torch.zeros_like(a)],
                                                dim=0)

    if use_cfg:
        cross_attn_cond, prepend_cond = (null_pair(cross_attn_cond),
                                         null_pair(prepend_cond))
        global_cond, cross_attn_mask = (null_pair(global_cond),
                                        dup(cross_attn_mask))
    cache = model.init_cache(2 * batch if use_cfg else batch,
                             n_prep + steps + 1)

    def net(tokens, pos, prepend=None):
        nonlocal cache
        logits, cache = model(dup(tokens) if use_cfg else tokens,
                              cross_attn_cond=cross_attn_cond,
                              cross_attn_mask=cross_attn_mask,
                              prepend_cond=prepend, global_cond=global_cond,
                              cache=cache, cache_index=pos)
        logits = logits[:, :, -1]
        if not use_cfg:
            return logits
        cond, uncond = logits.chunk(2, dim=0)
        return uncond + (cond - uncond) * cfg_scale

    def draw(i, logits):
        if temperature <= 0:
            return None
        if gumbel is not None:
            return gumbel[i]
        return gumbel_noise(logits.shape, generator, device=logits.device)

    out = torch.full((batch, n_q, steps), model.special_token,
                     dtype=torch.long, device=device)
    bos = torch.full((batch, n_q, 1), model.special_token, dtype=torch.long,
                     device=device)
    logits = net(bos, 0, prepend=prepend_cond)
    tok = _sample_tokens(logits, temperature, top_k, top_p, draw(0, logits))
    out[:, :, 0] = tok
    for i in range(steps - 1):
        logits = net(tok[..., None], n_prep + 1 + i)
        tok = _sample_tokens(logits, temperature, top_k, top_p,
                             draw(i + 1, logits))
        out[:, :, i + 1] = tok
    valid = _pattern_valid_mask(pattern, batch, length, device)
    return pattern.revert(torch.where(valid, out, model.special_token))


__all__ = ["AudioLM", "CoarseFirstPattern", "CustomDelayPattern",
           "DelayPattern", "Embed", "MusicLMPattern", "ParallelPattern",
           "UnrolledPattern", "gumbel_noise", "lm_generate", "lm_loss"]
