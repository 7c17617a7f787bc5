"""The port's adp U-Nets (ditsep_tpu_torch/models/unet1d.py) against the
JAX package's (ditsep_tpu/models/unet1d.py), the cases of
tests/test_unet1d.py, on seeded inputs with the JAX parameters redrawn from
a seed (no zero-initialised layer) and carried over by ``params_from_jax``:
``UNet1d``, ``UNetNCCA1d``, ``NumberEmbedder``, the dispatch and the
factory's adapter here, ``UNetCFG1d`` in tests/test_torch_unet1d_cfg.py.

Bar: 1e-4 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import unet1d as ju
from ditsep_tpu_torch.models import unet1d as tu
from stable_audio_parity import init_shapes, load_jax, max_rel, redraw

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


def _check(jm, tm, args, kw, scalars=None, seed=3):
    """Init JAX on (args, kw), redraw, load, compare one call (with the
    Python ``scalars`` added to both)."""
    params = redraw(init_shapes(jm, *[jnp.asarray(a) for a in args],
                                **_j(kw)), seed)
    load_jax(tm, params)
    scalars = scalars or {}
    want = np.asarray(jax.jit(lambda p, a, k: jm.apply(p, *a, **k,
                                                       **scalars))(
        params, [jnp.asarray(a) for a in args], _j(kw)))
    with torch.no_grad():
        got = tm(*[torch.from_numpy(a) for a in args], **_t(kw), **scalars)
    assert got.shape == want.shape
    assert max_rel(got, want) <= MODEL_BAR
    return params, got


UNET = dict(in_channels=4, channels=8, multipliers=(1, 2, 2), factors=(2, 2),
            num_blocks=(1, 1), attentions=(0, 1, 1))


@pytest.mark.parametrize("case", ["full_surface", "causal_odd_factors",
                                  "no_context_time"])
def test_unet1d_matches_jax(case):
    """The full conditioning surface (patching, context channels at two
    layers, context features, cross-attention embeddings with a mask),
    a causal net with odd pooling factors, and a net with no mapping."""
    x = _x((2, 4, 48), 1)
    t = np.full((2,), 0.5, np.float32)
    if case == "full_surface":
        kw = dict(UNET, patch_size=2, context_features=8,
                  context_channels=(3, 0, 5), context_embedding_features=12)
        mask = np.ones((2, 6), bool)
        mask[1, 4:] = False
        ckw = dict(features=_x((2, 8), 2),
                   channels_list=[_x((2, 3, 48), 3), _x((2, 5, 6), 4)],
                   embedding=_x((2, 6, 12), 5), embedding_mask=mask)
    elif case == "causal_odd_factors":
        kw = dict(UNET, factors=(3, 2), causal=True, attentions=(1, 1, 1),
                  out_channels=2, resnet_groups=4)
        x = _x((2, 4, 54), 1)
        ckw = {}
    else:
        kw = dict(UNET, use_context_time=False, use_skip_scale=False,
                  attentions=(0, 0))
        ckw = {}
    jm, tm = ju.UNet1d(**kw), tu.UNet1d(**kw)
    _check(jm, tm, [x, t], ckw)


def test_unet_ncca_and_number_embedder():
    """NCCA with JAX's per-item noise draws (its key split an item) and
    the number embedder alone."""
    kw = dict(context_features=16, in_channels=4, channels=16,
              multipliers=(1, 2), factors=(2,), num_blocks=(1,),
              attentions=(0, 0), context_channels=(2,))
    jm, tm = ju.UNetNCCA1d(**kw), tu.UNetNCCA1d(**kw)
    x, t = _x((2, 4, 32), 13), np.full((2,), 0.5, np.float32)
    ch = _x((2, 2, 32), 14)
    params = redraw(init_shapes(jm, jnp.asarray(x), jnp.asarray(t),
                                channels_list=[jnp.asarray(ch)]), 15)
    load_jax(tm, params)
    key = jax.random.PRNGKey(2)
    scale = np.asarray([0.25, 0.6], np.float32)
    want = np.asarray(jax.jit(lambda p, a, b, c, s, k: jm.apply(
        p, a, b, channels_list=[c], channels_scale=s, noise_key=k))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ch),
        jnp.asarray(scale)[:, None], key))
    _, sub = jax.random.split(key)
    noise = [torch.from_numpy(np.array(jax.random.normal(sub, ch.shape)))]
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 channels_list=[torch.from_numpy(ch)],
                 channels_scale=torch.from_numpy(scale)[:, None],
                 noise=noise)
    assert max_rel(got, want) <= MODEL_BAR
    je, te = ju.NumberEmbedder(features=32), tu.NumberEmbedder(features=32)
    v = np.asarray([[0.5, 1.0], [2.0, -3.0]], np.float32)
    _check(je, te, [v], {})


def test_xunet_dispatch_and_factory():
    """The dispatch and the reference-JSON factory; the adapter's
    conditioning names against JAX's adapter (CFG guidance through
    ``cfg_scale``, ``input_concat_cond`` as context channels)."""
    assert isinstance(tu.XUNet1d("base", in_channels=2), tu.UNet1d)
    assert isinstance(tu.XUNet1d("cfg", context_embedding_max_length=4,
                                 context_embedding_features=8), tu.UNetCFG1d)
    assert isinstance(tu.XUNet1d("ncca", context_features=8), tu.UNetNCCA1d)
    with pytest.raises(ValueError):
        tu.XUNet1d("nope")
    cfg = {"in_channels": 2, "channels": 8, "multipliers": [1, 2, 2],
           "factors": [2, 2], "num_blocks": [1, 1], "attentions": [0, 1, 1],
           "context_embedding_features": 12, "context_embedding_max_length": 8,
           "context_channels": [3]}
    jw = ju.create_unet_from_config("adp_cfg_1d", cfg)
    tw = tu.create_unet_from_config("adp_cfg_1d", cfg)
    assert isinstance(tw, tu.UNetCondAdapter) and tw.io_channels == 2
    x, t = _x((1, 2, 32), 16), np.full((1,), 0.3, np.float32)
    kw = dict(cross_attn_cond=_x((1, 4, 12), 17),
              input_concat_cond=_x((1, 3, 32), 18))
    _check(jw, tw, [x, t], kw, scalars={"cfg_scale": 2.0})
    with pytest.raises(ValueError):
        tw(torch.from_numpy(x), torch.from_numpy(t))
    uncond = {"in_channels": 2, "channels": 8, "multipliers": [1, 2],
              "factors": [2], "num_blocks": [1], "attentions": [0, 0]}
    _check(ju.create_unet_from_config("adp_1d", uncond),
           tu.create_unet_from_config("adp_1d", uncond), [x, t], {})
