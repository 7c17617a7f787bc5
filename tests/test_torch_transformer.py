"""The port's continuous transformer (ditsep_tpu_torch/models/transformer.py)
against the JAX package's (ditsep_tpu/models/transformer.py) on seeded
inputs, the JAX parameters redrawn from a seed and carried over by
``params_from_jax``.

Bars: the ops (rotary table and embedding, masks, LayerNorm) 1e-5 abs;
attention, blocks and the stack 1e-4 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import transformer as jt
from ditsep_tpu_torch.models import transformer as tt
from stable_audio_parity import init_shapes, load_jax, max_rel, redraw

KEY = jax.random.PRNGKey(0)
MODEL_BAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("seq,rot_dim,interp", [(7, 32, 1.0), (33, 16, 2.0)])
def test_rotary_table_and_embedding(seq, rot_dim, interp):
    want = np.asarray(jt.rotary_freqs(seq, rot_dim,
                                      interpolation_factor=interp))
    got = tt.rotary_freqs(seq, rot_dim, interpolation_factor=interp)
    np.testing.assert_array_equal(got.numpy(), want)
    t = _x((2, 3, seq - 2, 40), 1)  # partial rotation, the table longer
    ref = np.asarray(jt.apply_rotary_pos_emb(jnp.asarray(t),
                                             jnp.asarray(want)))
    out = tt.apply_rotary_pos_emb(torch.from_numpy(t), got).numpy()
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("window", [(-1, -1), (2, -1), (-1, 1), (3, 0)])
def test_sliding_window_mask(window):
    want = jt.sliding_window_mask(5, 8, window)
    got = tt.sliding_window_mask(5, 8, window)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layer_norm_matches_flax():
    import flax.linen as nn
    x = _x((3, 5, 24)) * 3 + 1
    ln = nn.LayerNorm(epsilon=1e-5)
    params = redraw(init_shapes(ln, jnp.asarray(x)), 3)
    want = np.asarray(ln.apply(params, jnp.asarray(x)))
    got = load_jax(tt.LayerNorm(24, 1e-5), params)(torch.from_numpy(x))
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5


def _check(jmod, tmod, args, kwargs, seed=5, torch_kwargs=None):
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: (None if v is None else jnp.asarray(v))
           for k, v in kwargs.items()}
    params = redraw(init_shapes(jmod, *jargs, **jkw), seed)
    want = np.asarray(jax.jit(lambda p, a, kw: jmod.apply(p, *a, **kw))(
        params, jargs, jkw))
    load_jax(tmod, params)
    tkw = {k: (None if v is None else torch.from_numpy(np.asarray(v)))
           for k, v in (torch_kwargs or kwargs).items()}
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) for a in args], **tkw)
    assert max_rel(got, want) <= MODEL_BAR
    return got, want


ATTN_CASES = {
    "plain": {},
    "rope": {"rope": True},
    "causal": {"causal": True, "rope": True},
    "window": {"sliding_window": (2, 1)},
    "key_mask": {"mask": True},
    "masked_row": {"mask": "row", "causal": True},
    "qk_ln": {"qk_norm": "ln", "rope": True},
    "qk_l2": {"qk_norm": "l2", "mask": True},
    "cross": {"context": 12},
    "cross_mask_ln": {"context": 12, "mask": True, "qk_norm": "ln"},
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_jax(case):
    c = ATTN_CASES[case]
    dim, heads, n = 32, 8, 9
    x = _x((2, n, dim))
    kw, args = {}, [x]
    jkw = dict(dim_heads=heads, causal=c.get("causal", False),
               qk_norm=c.get("qk_norm", "none"),
               sliding_window=c.get("sliding_window", (-1, -1)))
    if "context" in c:
        jkw["dim_context"] = c["context"]
        kw["context"] = _x((2, 6, c["context"]), 2)
    kn = 6 if "context" in c else n
    if c.get("mask") is True:
        m = np.ones((2, kn), bool)
        m[1, kn - 3:] = False
        kw["mask"] = m
    elif c.get("mask") == "row":  # one batch row with every key masked
        m = np.ones((2, kn), bool)
        m[1] = False
        kw["mask"] = m
    if c.get("rope"):
        kw["rotary_pos_emb"] = np.asarray(jt.rotary_freqs(n, 4))
    jmod = jt.Attention(dim, zero_init_output=False, **jkw)
    tmod = tt.Attention(dim, dim_context=jkw.pop("dim_context", None),
                        zero_init_output=False, **jkw)
    got, want = _check(jmod, tmod, args, kw)
    if c.get("mask") == "row" and "context" not in c:
        # every query of the masked row is zeroed, not NaN
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("adaln,cross", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_transformer_block_matches_jax(adaln, cross):
    dim = 32
    x = _x((2, 7, dim))
    kw = {"rotary_pos_emb": np.asarray(jt.rotary_freqs(7, 4))}
    if adaln:
        kw["global_cond"] = _x((2, 6 * dim), 3)
    if cross:
        kw["context"] = _x((2, 5, 20), 4)
    jmod = jt.TransformerBlock(dim, dim_heads=8, cross_attend=cross,
                               dim_context=20 if cross else None,
                               global_cond_dim=dim if adaln else None,
                               zero_init_branch_outputs=False)
    tmod = tt.TransformerBlock(dim, dim_heads=8, cross_attend=cross,
                               dim_context=20 if cross else None,
                               global_cond_dim=dim if adaln else None,
                               zero_init_branch_outputs=False)
    _check(jmod, tmod, [x], kw)


TRANSFORMER_MODES = {
    # the DiT's modes: prepended tokens (with and without their mask),
    # adaLN global conditioning, cross-attention with a context mask,
    # dim_in / dim_out projections
    "prepend": dict(prepend=True),
    "prepend_masked": dict(prepend=True, masks=True),
    "adaln_cross": dict(global_cond=True, context=True),
    "all_masked": dict(prepend=True, global_cond=True, context=True,
                       masks=True, qk_norm="ln"),
    "window_final_cross": dict(sliding_window=(2, 2), context=True,
                               final_cross_attn_ix=0),
}


@pytest.mark.parametrize("mode", sorted(TRANSFORMER_MODES))
def test_continuous_transformer_matches_jax(mode):
    c = TRANSFORMER_MODES[mode]
    dim, b, n = 32, 2, 6
    x = _x((b, n, 10))
    kw = {}
    if c.get("prepend"):
        kw["prepend_embeds"] = _x((b, 2, dim), 7)
    if c.get("global_cond"):
        kw["global_cond"] = _x((b, 16), 8)
    if c.get("context"):
        kw["context"] = _x((b, 4, 12), 9)
    if c.get("masks"):
        m = np.ones((b, n), bool)
        m[1, -2:] = False
        kw["mask"] = m
        if c.get("prepend"):
            pm = np.ones((b, 2), bool)
            pm[0, 0] = False
            kw["prepend_mask"] = pm
        if c.get("context"):
            cm = np.ones((b, 4), bool)
            cm[1, -1] = False
            kw["context_mask"] = cm
    common = dict(dim_in=10, dim_out=5, dim_heads=8,
                  cross_attend=bool(c.get("context")),
                  cond_token_dim=12 if c.get("context") else None,
                  final_cross_attn_ix=c.get("final_cross_attn_ix", -1),
                  global_cond_dim=16 if c.get("global_cond") else None,
                  qk_norm=c.get("qk_norm", "none"),
                  sliding_window=c.get("sliding_window", (-1, -1)),
                  zero_init_branch_outputs=False)
    jmod = jt.ContinuousTransformer(dim, 2, **common)
    tmod = tt.ContinuousTransformer(dim, 2, **common)
    _check(jmod, tmod, [x], kw)


def test_return_info_hidden_states():
    x = torch.from_numpy(_x((1, 5, 16)))
    m = tt.ContinuousTransformer(16, 3, dim_heads=8).eval()
    with torch.no_grad():
        out, info = m(x, return_info=True)
    assert len(info["hidden_states"]) == 3
    assert info["hidden_states"][-1].shape == out.shape


@pytest.mark.parametrize("part", ["cache", "conformer"])
def test_lm_only_paths_raise(part):
    """The token LM's parts, which raised before the LM was ported,
    against JAX: ``cache``, a causal RoPE stack's cached decode (a
    two-token prefill, then one token a step, written in place at
    ``cache_index`` into the preallocated cache) step by step against
    JAX's cached decode and against the full pass; ``conformer``, the
    conformer block (alone, and in a layer-scaled block)."""
    dim, n = 32, 6
    x = _x((2, n, dim), 11)
    if part == "conformer":
        c = _x((2, 9, dim), 12)
        _check(jt.ConformerModule(), tt.ConformerModule(dim), [c], {})
        _check(jt.TransformerBlock(dim, dim_heads=8, conformer=True,
                                   layer_scale=True),
               tt.TransformerBlock(dim, dim_heads=8, conformer=True,
                                   layer_scale=True),
               [c], {"rotary_pos_emb": np.asarray(jt.rotary_freqs(9, 4))})
        return
    common = dict(dim_heads=8, causal=True, zero_init_branch_outputs=False)
    jmod = jt.ContinuousTransformer(dim, 2, **common)
    tmod = tt.ContinuousTransformer(dim, 2, **common)
    params = redraw(init_shapes(jmod, jnp.asarray(x)), 13)
    load_jax(tmod, params)
    step = jax.jit(lambda p, a, c, i: jmod.apply(p, a, cache=c,
                                                 cache_index=i))
    jcache, tcache = jmod.init_cache(2, n + 1), tmod.init_cache(2, n + 1)
    spans = [(0, 2)] + [(i, i + 1) for i in range(2, n)]
    got, want = [], []
    for a, b in spans:
        out, jcache = step(params, jnp.asarray(x[:, a:b]), jcache,
                           jnp.asarray(a, jnp.int32))
        want.append(np.asarray(out))
        with torch.no_grad():
            out, tcache = tmod(torch.from_numpy(x[:, a:b]), cache=tcache,
                               cache_index=a)
        got.append(out)
        assert out.shape == (2, b - a, dim)
    got = torch.cat(got, dim=1)
    assert max_rel(got, np.concatenate(want, axis=1)) <= MODEL_BAR
    with torch.no_grad():
        full = tmod(torch.from_numpy(x))
    assert max_rel(got, full) <= MODEL_BAR
    # the caches are the ones allocated, written in place
    assert tcache[0][0].shape == (2, 4, n + 1, 8)
    assert not tcache[0][0][:, :, n:].any()
