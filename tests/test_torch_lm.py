"""The port's token LM (ditsep_tpu_torch/models/lm.py) against the JAX
package's (ditsep_tpu/models/lm.py) on seeded inputs, the JAX parameters
redrawn from a seed (no zero-initialised layer) and carried over by
``params_from_jax``.

Bars: patterns, masks and tokens exact; the full pass, the cached decode
and the loss 1e-4 of max|ref|. The cached decode is held teacher-forced:
one token sequence goes through both packages' decode steps and every
step's logits are compared, since one near-tied logit flipped by float32
rounding changes every later sampled step. Whole generated sequences are
compared only where each step's top-2 margin of the Gumbel-perturbed
logits clears 1e-3, on JAX's own draws (``jax.random.categorical`` is
Gumbel-max: the argmax of the logits plus ``jax.random.gumbel`` of its
key).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import lm as jl
from ditsep_tpu_torch.models import lm as tl
from ditsep_tpu_torch.models.weights import params_to_jax
from stable_audio_parity import flat, init_shapes, load_jax, max_rel, redraw

MODEL_BAR = 1e-4
MARGIN_BAR = 1e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(shape, high, seed=0):
    return np.random.default_rng(seed).integers(0, high, shape)


PATTERNS = {
    "delay": lambda s: (jl.DelayPattern(4, s), tl.DelayPattern(4, s)),
    "parallel": lambda s: (jl.ParallelPattern(4, s),
                           tl.ParallelPattern(4, s)),
    "custom_delay": lambda s: (jl.CustomDelayPattern(4, s, (0, 1, 1, 3)),
                               tl.CustomDelayPattern(4, s, (0, 1, 1, 3))),
    "coarse_first": lambda s: (jl.CoarseFirstPattern(4, s, (0, 1, 2)),
                               tl.CoarseFirstPattern(4, s, (0, 1, 2))),
    "unrolled": lambda s: (jl.UnrolledPattern(4, s),
                           tl.UnrolledPattern(4, s)),
    "unrolled_partial_delayed": lambda s: (
        jl.UnrolledPattern(4, s, (0, 0, 1, 2), (0, 0, 1, 1)),
        tl.UnrolledPattern(4, s, (0, 0, 1, 2), (0, 0, 1, 1))),
    "musiclm": lambda s: (jl.MusicLMPattern(4, s, 2),
                          tl.MusicLMPattern(4, s, 2)),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_pattern_apply_revert_and_valid_mask(name):
    jp, tp = PATTERNS[name](16)
    tok = _tokens((2, 4, 5), 16, seed=1)
    want = np.asarray(jp.apply(jnp.asarray(tok, jnp.int32)))
    got = tp.apply(torch.from_numpy(tok))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tp.revert(got).numpy(),
                                  np.asarray(jp.revert(jnp.asarray(want))))
    np.testing.assert_array_equal(tp.revert(got).numpy(), tok)
    np.testing.assert_array_equal(
        tl._pattern_valid_mask(tp, 3, 5).numpy(),
        np.asarray(jl._pattern_valid_mask(jp, 3, 5)))


def test_pattern_refusals():
    with pytest.raises(ValueError):
        tl.CustomDelayPattern(3, 8, (2, 1, 0))
    with pytest.raises(ValueError):
        tl.UnrolledPattern(3, 8, (0, 0, 1), (0, 1, 1))


LM_MODES = {
    "plain": {},
    "cross": {"cross": 6, "mask": True},
    "prepend": {"prepend": 5},
    "global": {"global": 4},
    "all_conformer": {"cross": 6, "prepend": 5, "global": 4,
                      "conformer": True},
}


def _lm_pair(c, n_q=3, card=12, dim=16, depth=2, heads=2):
    kw = dict(n_quantizers=n_q, codebook_size=card, dim=dim, depth=depth,
              num_heads=heads, cross_attn_cond_dim=c.get("cross", 0),
              prepend_cond_dim=c.get("prepend", 0),
              global_cond_dim=c.get("global", 0),
              conformer=c.get("conformer", False))
    return jl.AudioLM(**kw), tl.AudioLM(**kw)


def _cond_inputs(c, b, seed=3):
    kw = {}
    if c.get("cross"):
        kw["cross_attn_cond"] = _x((b, 4, c["cross"]), seed)
        if c.get("mask"):
            m = np.ones((b, 4), bool)
            m[-1, -2:] = False
            kw["cross_attn_mask"] = m
    if c.get("prepend"):
        kw["prepend_cond"] = _x((b, 2, c["prepend"]), seed + 1)
    if c.get("global"):
        kw["global_cond"] = _x((b, c["global"]), seed + 2)
    return kw


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}


def _init(jm, tm, tok, kw, seed=5):
    params = redraw(init_shapes(jm, jnp.asarray(tok, jnp.int32), **_j(kw)),
                    seed)
    load_jax(tm, params)
    return params


@pytest.mark.parametrize("mode", sorted(LM_MODES))
def test_audio_lm_full_pass_matches_jax(mode):
    c = LM_MODES[mode]
    jm, tm = _lm_pair(c)
    tok = _tokens((2, 3, 7), 13, seed=2)  # 12 is the special token
    kw = _cond_inputs(c, 2)
    params = _init(jm, tm, tok, kw)
    want = np.asarray(jax.jit(lambda p, t, k: jm.apply(p, t, **k))(
        params, jnp.asarray(tok, jnp.int32), _j(kw)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tok), **_t(kw))
    assert got.shape == want.shape == (2, 3, 7, 12)
    assert max_rel(got, want) <= MODEL_BAR
    # the parameters cross back to the JAX tree they came from
    back = params_to_jax(tm)
    want_flat = {k[len("params/"):]: v for k, v in flat(params).items()}
    assert set(back) == set(want_flat)
    assert all(np.array_equal(back[k], v) for k, v in want_flat.items())


def _decode_steps_jax(jm, params, tokens, kw, n_prep):
    """JAX's cached decode, teacher-forced: the prefill of the prepend and
    tokens[..., 0], then one step a token; logits (B, n_q, S, C)."""
    b, _, s = tokens.shape
    cache = jm.init_cache(b, n_prep + s + 1)
    step = jax.jit(lambda p, t, c, i, k: jm.apply(p, t, cache=c,
                                                  cache_index=i, **k))
    prefill = {k: v for k, v in kw.items() if k != "prepend_cond"}
    out = []
    lg, cache = step(params, jnp.asarray(tokens[..., :1], jnp.int32), cache,
                     jnp.asarray(0, jnp.int32), kw)
    out.append(lg[:, :, -1])
    for i in range(1, s):
        lg, cache = step(params, jnp.asarray(tokens[..., i:i + 1],
                                             jnp.int32), cache,
                         jnp.asarray(n_prep + i, jnp.int32), prefill)
        out.append(lg[:, :, -1])
    return np.stack([np.asarray(o) for o in out], axis=2)


def _decode_steps_torch(tm, tokens, kw, n_prep):
    b, _, s = tokens.shape
    cache = tm.init_cache(b, n_prep + s + 1)
    prefill = {k: v for k, v in kw.items() if k != "prepend_cond"}
    out = []
    with torch.no_grad():
        for i in range(s):
            lg, cache = tm(torch.from_numpy(tokens[..., i:i + 1]),
                           cache=cache, cache_index=0 if i == 0 else
                           n_prep + i, **(kw if i == 0 else prefill))
            out.append(lg[:, :, -1])
    return torch.stack(out, dim=2)


@pytest.mark.parametrize("mode", ["plain", "prepend", "all_conformer"])
def test_cached_decode_teacher_forced_matches_jax(mode):
    """Every step's logits of the cached decode against JAX's cached
    decode on one token sequence (with the conformer too: its conv sees
    only the step's token in both packages, so the cached decode differs
    from the full pass there, in JAX as in the port)."""
    c = LM_MODES[mode]
    jm, tm = _lm_pair(c)
    tok = _tokens((2, 3, 6), 13, seed=4)
    kw = _cond_inputs(c, 2)
    params = _init(jm, tm, tok, kw, seed=6)
    n_prep = 2 if c.get("prepend") else 0
    want = _decode_steps_jax(jm, params, tok, _j(kw), n_prep)
    got = _decode_steps_torch(tm, tok, _t(kw), n_prep)
    assert got.shape == want.shape == (2, 3, 6, 12)
    assert max_rel(got, want) <= MODEL_BAR
    if not c.get("conformer"):  # without it the decode is the full pass
        with torch.no_grad():
            full = tm(torch.from_numpy(tok), **_t(kw))
        assert max_rel(got, full) <= MODEL_BAR


def test_lm_kv_cache_matches_full_pass():
    """The port's mirror of the JAX package's test of the same name
    (tests/test_generative.py): one token a step through the cache gives
    the full causal pass's logits."""
    jm, tm = _lm_pair({}, n_q=2, card=16, dim=32, depth=2)
    tok = _tokens((2, 2, 6), 16, seed=7)
    _init(jm, tm, tok, {})
    with torch.no_grad():
        full = tm(torch.from_numpy(tok))
        cache = tm.init_cache(2, 6)
        steps = []
        for i in range(6):
            lg, cache = tm(torch.from_numpy(tok[..., i:i + 1]), cache=cache,
                           cache_index=i)
            steps.append(lg[:, :, 0])
    np.testing.assert_allclose(torch.stack(steps, 2).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_lm_kv_cache_prefill_matches_full_pass():
    """The mirror of the JAX test of the same name: a multi-token prefill
    (prepend conditioning and the first tokens) gives the full pass."""
    jm, tm = _lm_pair({"prepend": 8}, n_q=2, card=16, dim=32, depth=1)
    tok = _tokens((1, 2, 5), 16, seed=8)
    prep = _x((1, 3, 8), 9)
    _init(jm, tm, tok, {"prepend_cond": prep})
    with torch.no_grad():
        full = tm(torch.from_numpy(tok), prepend_cond=torch.from_numpy(prep))
        lg, _ = tm(torch.from_numpy(tok), prepend_cond=torch.from_numpy(prep),
                   cache=tm.init_cache(1, 3 + 5), cache_index=0)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("pattern", ["delay", "unrolled"])
def test_lm_loss_matches_jax(pattern):
    jm, tm = _lm_pair({})
    tok = _tokens((2, 3, 5), 12, seed=10)
    params = _init(jm, tm, np.zeros((1, 3, 5), np.int64), {}, seed=11)
    jp = (jl.UnrolledPattern(3, 12) if pattern == "unrolled"
          else jl.DelayPattern(3, 12))
    tp = (tl.UnrolledPattern(3, 12) if pattern == "unrolled"
          else tl.DelayPattern(3, 12))
    want = float(jax.jit(lambda p, t: jl.lm_loss(jm, p, t, jp))(
        params, jnp.asarray(tok, jnp.int32)))
    with torch.no_grad():
        got = float(tl.lm_loss(tm, torch.from_numpy(tok), tp))
    assert abs(got - want) <= MODEL_BAR * abs(want)


def test_top_k_and_top_p_masks_with_ties():
    """Tied logits keep their order in both (a stable sort); the nucleus
    cut is compared where no exclusive prefix mass lies within float32
    rounding of p: there the cumulative sum's order decides (XLA sums in
    float32 in sequence, PyTorch's CPU cumsum accumulates in float64), a
    rounding near-tie like a near-tied logit."""
    logits = _x((3, 2, 10), 12) * 2
    logits[0, 0, [1, 4, 7]] = 3.0  # a three-way tie at the top
    logits[1, 1, [2, 3]] = -0.5
    logits[2, 0] = 0.25  # all tied
    for k in (1, 3, 4):
        want = np.asarray(jl._mask_top_k(jnp.asarray(logits), k))
        np.testing.assert_array_equal(
            tl._mask_top_k(torch.from_numpy(logits), k).numpy(), want)
    srt = -np.sort(-logits, axis=-1)
    probs = np.exp(srt - srt.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    excl = np.cumsum(probs, -1) - probs
    for p in (0.35, 0.65, 0.95):
        assert np.abs(excl - p).min() > 1e-5
        want = np.asarray(jl._mask_top_p(jnp.asarray(logits), p))
        np.testing.assert_array_equal(
            tl._mask_top_p(torch.from_numpy(logits), p).numpy(), want)


def test_categorical_is_gumbel_max():
    """``jax.random.categorical`` is the argmax of the logits plus
    ``jax.random.gumbel`` of the same key: the draws the port is given."""
    logits = jnp.asarray(_x((4, 3, 50), 13))
    for seed in range(3):
        k = jax.random.PRNGKey(seed)
        want = jax.random.categorical(k, logits, axis=-1)
        got = jnp.argmax(logits + jax.random.gumbel(k, logits.shape), -1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jax_draws(key, steps, shape):
    """The Gumbel draws of JAX's lm_generate: one split for the prefill,
    then one split a decode step."""
    key, sub = jax.random.split(key)
    draws = [jax.random.gumbel(sub, shape)]
    for _ in range(steps - 1):
        key, sub = jax.random.split(key)
        draws.append(jax.random.gumbel(sub, shape))
    return [torch.from_numpy(np.array(d)) for d in draws]


def _sampled_with_margins(tm, steps, draws, kw, top_k, top_p, cfg,
                          n_prep):
    """The port's decode loop written out: each step's Gumbel-perturbed
    logits, their top-2 gap, and the sampled token fed to the next step.
    Returns the raw (B, n_q, S) grid and the smallest gap a step."""
    use_cfg = cfg != 1.0 and bool(kw)
    if use_cfg:
        kw = {k: (torch.cat([v, v]) if k == "cross_attn_mask"
                  else torch.cat([v, torch.zeros_like(v)]))
              for k, v in kw.items()}
    b = draws[0].shape[0]
    cache = tm.init_cache(2 * b if use_cfg else b, n_prep + steps + 1)
    prefill = {k: v for k, v in kw.items() if k != "prepend_cond"}
    prev = torch.full((b, tm.n_quantizers, 1), tm.special_token)
    grid, gaps = [], []
    with torch.no_grad():
        for i in range(steps):
            toks = torch.cat([prev, prev]) if use_cfg else prev
            lg, cache = tm(toks, cache=cache,
                           cache_index=0 if i == 0 else n_prep + i,
                           **(kw if i == 0 else prefill))
            lg = lg[:, :, -1]
            if use_cfg:
                cond, unc = lg.chunk(2)
                lg = unc + (cond - unc) * cfg
            lg = (tl._mask_top_p(lg, top_p) if top_p > 0
                  else tl._mask_top_k(lg, top_k)) + draws[i]
            top2 = torch.topk(lg, 2, dim=-1).values
            gaps.append(float((top2[..., 0] - top2[..., 1]).min()))
            prev = lg.argmax(dim=-1)[..., None]
            grid.append(prev)
    return torch.cat(grid, dim=-1), gaps


GEN_CASES = {
    "top_k": dict(cond={}, cfg=1.0, top_k=5, top_p=0.0, seed=21),
    "top_p_cfg": dict(cond={"cross": 6, "prepend": 5, "global": 4},
                      cfg=3.0, top_k=0, top_p=0.8, seed=22),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_lm_generate_on_jax_draws(case):
    """``lm_generate`` on JAX's draws gives JAX's tokens, where every
    step's top-2 margin clears the bar (with and without CFG)."""
    c = GEN_CASES[case]
    jm, tm = _lm_pair(c["cond"], n_q=3, card=12, dim=16, depth=1)
    kw = _cond_inputs(c["cond"], 1, seed=23)
    params = _init(jm, tm, np.zeros((1, 3, 2), np.int64), kw, seed=24)
    length, key = 4, jax.random.PRNGKey(c["seed"])
    steps = length + 2  # the delay pattern of 3 codebooks
    gen = dict(temperature=1.0, top_k=c["top_k"], top_p=c["top_p"],
               cfg_scale=c["cfg"])
    want = np.asarray(jax.jit(lambda p, k, c: jl.lm_generate(
        jm, p, k, 1, length, **gen, **c))(params, key, _j(kw)))
    draws = _jax_draws(key, steps, (1, 3, 12))
    got = tl.lm_generate(tm, 1, length, **gen, gumbel=draws, **_t(kw))
    grid, gaps = _sampled_with_margins(
        tm, steps, draws, _t(kw), c["top_k"], c["top_p"], c["cfg"],
        2 if c["cond"].get("prepend") else 0)
    assert min(gaps) > MARGIN_BAR, gaps
    pattern = tl.DelayPattern(3, 12)
    valid = tl._pattern_valid_mask(pattern, 1, length)
    np.testing.assert_array_equal(
        pattern.revert(torch.where(valid, grid, 12)).numpy(), got.numpy())
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_generate_greedy_and_generator_draws():
    """temperature 0 is the argmax, as in JAX; draws from a generator are
    reproducible and lie in the codebook."""
    jm, tm = _lm_pair({}, n_q=2, card=8, dim=16, depth=1)
    params = _init(jm, tm, np.zeros((1, 2, 2), np.int64), {}, seed=31)
    want = np.asarray(jax.jit(lambda p, k: jl.lm_generate(
        jm, p, k, 2, 5, temperature=0.0))(params, KEY))
    got = tl.lm_generate(tm, 2, 5, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    a, b = (tl.lm_generate(tm, 2, 5, top_k=3,
                           generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 8
    with pytest.raises(ValueError, match="draws"):
        tl.lm_generate(tm, 1, 2, top_k=3)
