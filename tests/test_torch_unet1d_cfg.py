"""The port's ``UNetCFG1d`` (ditsep_tpu_torch/models/unet1d.py) against
the JAX package's, the CFG cases of tests/test_unet1d.py: guidance with
std rescaling, negative embeddings with their mask, the appended time
token, and the CFG dropout on JAX's own Bernoulli draw (uniform < p of its
key); the JAX parameters redrawn from a seed, carried over by
``params_from_jax``. Bar: 1e-4 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import unet1d as ju
from ditsep_tpu_torch.models import unet1d as tu
from ditsep_tpu_torch.models.weights import params_to_jax
from stable_audio_parity import flat, init_shapes, load_jax, max_rel, redraw

MODEL_BAR = 1e-4
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


def _j(kw):
    return {k: (None if v is None else
                [jnp.asarray(a) for a in v] if isinstance(v, list)
                else jnp.asarray(v)) for k, v in kw.items()}


def _t(kw):
    return {k: (None if v is None else
                [torch.from_numpy(a) for a in v] if isinstance(v, list)
                else torch.from_numpy(np.asarray(v))) for k, v in kw.items()}


UNET = dict(in_channels=4, channels=8, multipliers=(1, 2, 2), factors=(2, 2),
            num_blocks=(1, 1), attentions=(0, 1, 1))


def _cfg_pair(**extra):
    kw = dict(UNET, context_embedding_max_length=8,
              context_embedding_features=12, attentions=(1, 1, 1), **extra)
    return ju.UNetCFG1d(**kw), tu.UNetCFG1d(**kw)


CFG_CASES = {
    "no_guidance": {},
    "rescale": {"embedding_scale": 3.0, "rescale_cfg": True,
                "scale_phi": 0.7},
    "negative": {"embedding_scale": 2.0, "negative": True},
    "xattn_time": {"embedding_scale": 2.0, "xattn_time": True},
}


@pytest.mark.parametrize("case", sorted(CFG_CASES))
def test_unet_cfg_guidance_matches_jax(case):
    c = dict(CFG_CASES[case])
    jm, tm = _cfg_pair(use_xattn_time=c.pop("xattn_time", False))
    x, t = _x((2, 4, 32), 6), np.asarray([0.3, 0.8], np.float32)
    mask = np.ones((2, 6), bool)
    mask[0, 5:] = False
    kw = dict(embedding=_x((2, 6, 12), 7), embedding_mask=mask)
    if c.pop("negative", False):
        neg_mask = np.ones((2, 6), bool)
        neg_mask[:, 3:] = False
        c.update(negative_embedding=_x((2, 6, 12), 8),
                 negative_embedding_mask=neg_mask)
    params = redraw(init_shapes(jm, jnp.asarray(x), jnp.asarray(t),
                                **_j(kw)), 9)
    load_jax(tm, params)
    scalars = {k: v for k, v in c.items() if not isinstance(v, np.ndarray)}
    arrays = {k: v for k, v in c.items() if isinstance(v, np.ndarray)}
    want = np.asarray(jax.jit(lambda p, a, b, k: jm.apply(
        p, a, b, **k, **scalars))(params, jnp.asarray(x), jnp.asarray(t),
                                  _j({**kw, **arrays})))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 **_t({**kw, **arrays}), **scalars)
    assert max_rel(got, want) <= MODEL_BAR
    # the parameters cross back to the JAX tree they came from
    back = params_to_jax(tm)
    want_flat = {k[len("params/"):]: v for k, v in flat(params).items()}
    assert set(back) == set(want_flat)
    assert all(np.array_equal(back[k], v) for k, v in want_flat.items())


def test_unet_cfg_dropout_on_jax_draws():
    """``embedding_mask_proba``: JAX's Bernoulli draw of its ``cfg_key``
    given as ``cfg_drop``; at probability 1 the output is the null
    context's."""
    jm, tm = _cfg_pair()
    x, t = _x((3, 4, 32), 10), np.full((3,), 0.4, np.float32)
    kw = dict(embedding=_x((3, 5, 12), 11))
    params = redraw(init_shapes(jm, jnp.asarray(x), jnp.asarray(t),
                                **_j(kw)), 12)
    load_jax(tm, params)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda p, a, b, k, e: jm.apply(
        p, a, b, embedding=e, embedding_mask_proba=0.5, cfg_key=k))(
        params, jnp.asarray(x), jnp.asarray(t), key,
        jnp.asarray(kw["embedding"])))
    drop = np.array(jax.random.bernoulli(key, 0.5, (3, 1, 1))).reshape(3)
    assert 0 < drop.sum() < 3  # both branches taken
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), **_t(kw),
                 embedding_mask_proba=0.5, cfg_drop=torch.from_numpy(drop))
        null = tm.fixed_embedding(5, 3)
        all_null = tm(torch.from_numpy(x), torch.from_numpy(t),
                      embedding=null, embedding_mask_proba=1.0,
                      cfg_drop=torch.ones(3, dtype=torch.bool))
        ref_null = tm(torch.from_numpy(x), torch.from_numpy(t),
                      embedding=null)
    assert max_rel(got, want) <= MODEL_BAR
    assert torch.equal(all_null, ref_null)
