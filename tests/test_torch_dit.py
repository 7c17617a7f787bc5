"""The port's DiffusionTransformer (ditsep_tpu_torch/models/dit.py) against
the JAX package's (ditsep_tpu/models/dit.py), and the DiT importer against
JAX's ``import_dit_params``.

The JAX parameters are redrawn from a seed (no zero-initialised layer may
hide a difference) and carried over by ``params_from_jax``. Cases: the
unconditioned pass, full conditioning (cross-attention, prepend,
input-concat, global), CFG with negative conditioning and ``scale_phi``,
the ``cfg_interval`` gate on both sides, adaLN, ``apply_cond_masks`` both
ways, CFG dropout on JAX's draws, patching. Bar: 1e-4 of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models.dit import DiffusionTransformer as JDiT
from ditsep_tpu.models.torch_import import import_dit_params as jax_import
from ditsep_tpu_torch.models.dit import DiffusionTransformer as TDiT
from ditsep_tpu_torch.models.torch_import import (
    dit_reference_state, import_dit_params,
)
from ditsep_tpu_torch.models.weights import params_from_jax
from stable_audio_parity import flat, init_shapes, load_jax, max_rel, redraw

KEY = jax.random.PRNGKey(0)
BAR = 1e-4
B, T = 2, 12
COMMON = dict(io_channels=4, embed_dim=32, depth=2, num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cond(kind, masks=False):
    """Conditioning kwargs (numpy) of a kind."""
    kw = {}
    if kind in ("full", "cfg"):
        kw["cross_attn_cond"] = _x((B, 5, 8), 10)
        kw["global_embed"] = _x((B, 6), 11)
        kw["prepend_cond"] = _x((B, 2, 7), 12)
        kw["input_concat_cond"] = _x((B, 3, T // 2), 13)
    if kind == "cfg":
        kw["negative_cross_attn_cond"] = _x((B, 5, 8), 14)
        neg = np.ones((B, 5), bool)
        neg[1, 3:] = False
        kw["negative_cross_attn_mask"] = neg
    if masks:
        cm = np.ones((B, 5), bool)
        cm[0, -2:] = False
        pm = np.ones((B, 2), bool)
        pm[1, 0] = False
        m = np.ones((B, T), bool)
        m[1, -3:] = False
        kw.update(cross_attn_cond_mask=cm, prepend_cond_mask=pm, mask=m)
    return kw


def _config(kind, **extra):
    cfg = dict(COMMON, **extra)
    if kind != "uncond":
        cfg.update(cond_token_dim=8, global_cond_dim=6, prepend_cond_dim=7,
                   input_concat_dim=3)
    return cfg


def _pair(cfg, args, kw, seed=3):
    jm = JDiT(**cfg)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    params = redraw(init_shapes(jm, *map(jnp.asarray, args), **jkw), seed)
    return jm, params, load_jax(TDiT(**cfg), params)


def _jax_apply(jm, params, x, t, kw, **call):
    """JAX's forward, jitted (the arrays as arguments: eager JAX compiles
    op by op, several times slower here)."""
    fn = jax.jit(lambda p, x, t, kw: jm.apply(p, x, t, **kw, **call))
    return np.asarray(fn(params, jnp.asarray(x), jnp.asarray(t),
                         {k: jnp.asarray(v) for k, v in kw.items()}))


def _run(cfg, kind, t=(0.3, 0.7), masks=False, seed=3, **call):
    x = _x((B, cfg["io_channels"], T), 1)
    t = np.asarray(t, np.float32)
    kw = _cond(kind, masks)
    jm, params, tm = _pair(cfg, (x, t), kw, seed)
    want = _jax_apply(jm, params, x, t, kw, **call)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 **{k: torch.from_numpy(v) for k, v in kw.items()}, **call)
    assert got.shape == want.shape
    assert max_rel(got, want) <= BAR, max_rel(got, want)
    return got.numpy(), want


@pytest.mark.parametrize("kind,gtype", [("uncond", "prepend"),
                                        ("full", "prepend"),
                                        ("uncond", "adaLN"),
                                        ("full", "adaLN")])
def test_forward_matches_jax(kind, gtype):
    _run(_config(kind, global_cond_type=gtype), kind)


@pytest.mark.parametrize("gtype,phi", [("prepend", 0.0), ("prepend", 0.7),
                                       ("adaLN", 0.4)])
def test_cfg_with_negative_cond_and_rescale(gtype, phi):
    _run(_config("cfg", global_cond_type=gtype), "cfg", cfg_scale=3.5,
         scale_phi=phi)


@pytest.mark.parametrize("objective", ["v", "rectified_flow"])
def test_cfg_interval_gate(objective):
    """Inside the interval the guided output, outside it the conditioned
    pass (sigma(t[0]) = sin(t pi / 2) for 'v', t itself otherwise)."""
    cfg = _config("cfg", diffusion_objective=objective)
    inside, _ = _run(cfg, "cfg", t=(0.5, 0.5), cfg_scale=4.0,
                     cfg_interval=(0.2, 0.9))
    outside, _ = _run(cfg, "cfg", t=(0.95, 0.95), cfg_scale=4.0,
                      cfg_interval=(0.2, 0.9))
    plain, _ = _run(cfg, "cfg", t=(0.95, 0.95), cfg_scale=1.0)
    np.testing.assert_allclose(outside, plain, rtol=0, atol=1e-5)
    assert np.abs(inside - outside).max() > 1e-3


@pytest.mark.parametrize("apply_masks", [False, True])
def test_cond_masks_both_ways(apply_masks):
    """apply_cond_masks=False (the parity default) ignores every mask; True
    applies them, and then masks change the output."""
    cfg = _config("full", apply_cond_masks=apply_masks)
    masked, _ = _run(cfg, "full", masks=True)
    unmasked, _ = _run(cfg, "full", masks=False)
    differs = np.abs(masked - unmasked).max() > 1e-4
    assert differs == apply_masks


def test_cfg_dropout_on_jax_draws():
    """CFG dropout nulls rows by JAX's uniform draws, handed to the port
    as ``cfg_dropout_uniform``; without draws or a generator it raises."""
    cfg = _config("full")
    x, t = _x((B, 4, T), 1), np.asarray([0.2, 0.6], np.float32)
    kw = _cond("full")
    jm, params, tm = _pair(cfg, (x, t), kw)
    key = jax.random.PRNGKey(11)
    want = _jax_apply(jm, params, x, t, dict(kw, rngs_key=key),
                      cfg_dropout_prob=0.5)
    k_cross, k_prep = jax.random.split(key)
    draws = tuple(torch.from_numpy(np.asarray(jax.random.uniform(
        k, (B, 1, 1)))) for k in (k_cross, k_prep))
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 cfg_dropout_prob=0.5, cfg_dropout_uniform=draws, **tkw)
        assert max_rel(got, want) <= BAR
        with pytest.raises(ValueError, match="generator"):
            tm(torch.from_numpy(x), torch.from_numpy(t),
               cfg_dropout_prob=0.5, **tkw)
        g = torch.Generator().manual_seed(0)
        assert tm(torch.from_numpy(x), torch.from_numpy(t),
                  cfg_dropout_prob=0.5, generator=g, **tkw).shape == got.shape


def test_patch_size_two():
    _run(_config("uncond", patch_size=2), "uncond")


def test_dit_importer_matches_jax():
    """One seeded DiT in the reference's state_dict layout (adaLN, cross
    attention, qk LayerNorms' absent here; a norm without its ``beta``
    buffer; the rotary buffer) through the port's ``import_dit_params``
    and JAX's: the port's parameters equal ``params_from_jax`` of JAX's
    imported tree bit for bit, and the forwards agree."""
    cfg = _config("full", global_cond_type="adaLN")
    x, t = _x((B, 4, T), 1), np.asarray([0.3, 0.8], np.float32)
    kw = _cond("full")
    _, params, src = _pair(cfg, (x, t), kw, seed=21)
    sd = {k: v.numpy() for k, v in dit_reference_state(src).items()}
    del sd["transformer.layers.1.ff_norm.beta"]
    sd["transformer.rotary_pos_emb.inv_freq"] = np.ones(4, np.float32)
    jtree = jax_import(sd, depth=cfg["depth"])
    tm = import_dit_params(TDiT(**cfg), sd).eval()
    want_state = params_from_jax(flat(jtree))
    got_state = tm.state_dict()
    assert set(got_state) == set(want_state)
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
    want = _jax_apply(JDiT(**cfg), jtree, x, t, kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert max_rel(got, want) <= BAR
    sd["transformer.layers.0.unknown"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="unknown"):
        import_dit_params(TDiT(**cfg), sd)


def test_params_to_jax_gives_the_jax_tree():
    """``params_to_jax`` of a loaded DiT (adaLN, every conditioning MLP,
    the conv1d pre / post, the Fourier features) is the JAX tree it was
    loaded from, bit for bit."""
    from ditsep_tpu_torch.models.weights import params_to_jax
    cfg = _config("full", global_cond_type="adaLN")
    _, params, tm = _pair(cfg, (_x((B, 4, T), 1), np.ones(2, np.float32)),
                          _cond("full"), seed=8)
    back = params_to_jax(tm)
    want = {k[len("params/"):]: v for k, v in flat(params).items()}
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
