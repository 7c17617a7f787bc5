"""models/torch_import.py against the JAX package's importers, on state
dicts this test writes in the reference's key layout (JAX's
``flax_path_to_torch_key`` and the inverse of its ``_convert_leaf``; the
OobleckVAE's through ``oobleck_flax_path_to_torch_key``); no reference
source is opened.

Bars, stated before the runs: the port's imported parameters equal
``params_from_jax`` of JAX's imported tree bit for bit; the score model's
outputs 1e-4 of max|ref| (the score-model bar); the EMA shadows applied
by parameter order bit for bit; the VAE's encode and decode 2e-5 abs
(tests/test_torch_oobleck.py's bar)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.models import torch_import as jti
from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep, override
from ditsep_tpu_torch.models import (
    diffsep_ema_param_order, import_diffsep_ema, import_ema_params,
    import_oobleck_params, import_params, load_torch_ckpt,
    oobleck_params_from_jax, params_from_jax,
)
from test_torch_oobleck import _flat, vae_pair
from test_torch_train import TINY

LENGTH = 1200


def _to_torch_layout(a, leaf):
    """The inverse of JAX's ``_convert_leaf``."""
    if leaf == "kernel":
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return a.T
    return a


@pytest.fixture(scope="module")
def pair():
    """The JAX trainer, its template parameters, the port's trainer, and
    seeded values for every leaf (far from the template's)."""
    jt = jax_build(jax_override(jax_diffsep(), TINY))
    tmpl = jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, LENGTH)),
        jnp.full((1,), 0.5), jnp.zeros((1, 1, LENGTH)))["params"]
    tt = build_diffsep_trainer(override(diffsep(), TINY), device="cpu")
    rng = np.random.default_rng(7)
    values = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in _flat(tmpl).items()}
    return jt, tmpl, tt, values


def _reference_state(values, prefix="", backbone=True):
    """``{torch key: array}`` in the reference layout: a full score
    model's keys (``backbone.`` first) or, with ``backbone=False``, a bare
    NCSNpp's."""
    out = {}
    for k, v in values.items():
        path = tuple(k.split("/"))
        if not backbone:
            path = path[1:]
        tkey = jti.flax_path_to_torch_key(path)
        a = _to_torch_layout(v, path[-1])
        np.testing.assert_array_equal(
            jti._convert_leaf(a, path[-1], v.shape), v)
        out[prefix + tkey] = a
    return out


def _jax_out(jt, params):
    rng = np.random.default_rng(3)
    xt = rng.standard_normal((2, 2, LENGTH)).astype(np.float32)
    t = np.array([0.4, 0.9], np.float32)
    mix = rng.standard_normal((2, 1, LENGTH)).astype(np.float32)
    want = np.asarray(jax.jit(jt.model.apply)(
        {"params": params}, jnp.asarray(xt), jnp.asarray(t),
        jnp.asarray(mix)))
    return (xt, t, mix), want


def _check_model(tt, jt, jax_params):
    """The port's parameters are params_from_jax of JAX's, and its score
    model's output is JAX's within 1e-4 of max|ref|."""
    want_state = params_from_jax({k: np.asarray(v) for k, v in
                                  _flat(jax_params["backbone"]).items()})
    got_state = tt.model.backbone.state_dict()
    assert set(got_state) == set(want_state)
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
    args, want = _jax_out(jt, jax_params)
    with torch.no_grad():
        got = tt.model.eval()(*map(torch.from_numpy, args)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("prefix", ["", "score_model.",
                                    "score_model.backbone."])
def test_import_params_matches_jax(pair, prefix):
    jt, tmpl, tt, values = pair
    if prefix == "score_model.":
        state = _reference_state(values, prefix)
        jax_params = jti.import_params(tmpl, state, prefix=prefix)
    else:
        state = _reference_state(values, prefix, backbone=False)
        if prefix:  # a full checkpoint also holds the sigmas buffer
            state[prefix + "sigmas"] = np.linspace(0.05, 1, 8,
                                                   dtype=np.float32)
        jax_params = {"backbone": jti.import_params(
            tmpl["backbone"], state, prefix=prefix)}
    if prefix:  # a key outside the prefix is not the score model's
        state["other_module.weight"] = np.zeros(3, np.float32)
    import_params(tt.model, {k: torch.from_numpy(v) for k, v in
                             state.items()}, prefix=prefix)
    _check_model(tt, jt, jax_params)
    # a bare NCSNpp takes the same dict
    bare = build_diffsep_trainer(override(diffsep(), TINY),
                                 device="cpu").model.backbone
    import_params(bare, state, prefix=prefix)
    for k, v in bare.state_dict().items():
        assert torch.equal(v, tt.model.backbone.state_dict()[k]), k


def test_import_params_names_what_it_cannot_place(pair):
    jt, tmpl, tt, values = pair
    state = _reference_state(values, "score_model.")
    gone = "score_model.backbone.all_modules.1.weight"
    missing = {k: v for k, v in state.items() if k != gone}
    with pytest.raises(KeyError, match="all_modules.1.weight"):
        import_params(tt.model, missing, prefix="score_model.")
    with pytest.raises(KeyError):
        jti.import_params(tmpl, missing, prefix="score_model.")
    extra = {**state, "score_model.backbone.all_modules.99.weight":
             np.zeros(2, np.float32)}
    with pytest.raises(KeyError, match="all_modules.99.weight"):
        import_params(tt.model, extra, prefix="score_model.")
    # not strict: what is missing keeps its value
    before = tt.model.state_dict()["backbone.all_modules.1.weight"].clone()
    import_params(tt.model, missing, prefix="score_model.", strict=False)
    assert torch.equal(tt.model.state_dict()["backbone.all_modules.1.weight"],
                       before)
    bad = {**state, gone: np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        import_params(tt.model, bad, prefix="score_model.")


def _lightning_ckpt(tt, values, n_extra_shadows=0):
    """A DiffSep Lightning checkpoint as the reference saves it: the
    score model under ``score_model.backbone.`` in registration order
    (the sigmas buffer first), and torch_ema's shadows, each trainable
    parameter perturbed, in parameter order."""
    ref = _reference_state(values, backbone=False)
    order = list(tt.model.backbone.state_dict())
    assert set(order) == set(ref)
    sd = {"score_model.backbone.sigmas": np.linspace(0.05, 1, 8,
                                                     dtype=np.float32)}
    sd.update({f"score_model.backbone.{k}": ref[k] for k in order})
    rng = np.random.default_rng(9)
    trainable = [k for k, _ in tt.model.backbone.named_parameters()]
    shadows = [ref[k] + 0.01 * rng.standard_normal(ref[k].shape).astype(
        np.float32) for k in trainable]
    shadows += [np.zeros(1, np.float32)] * n_extra_shadows
    return ({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
             "ema": {"shadow_params": [torch.from_numpy(s)
                                       for s in shadows]},
             "epoch": 29, "hyper_parameters": {"nf": 16}},
            trainable, shadows)


def test_import_diffsep_ema_matches_jax(pair, tmp_path):
    jt, tmpl, tt, values = pair
    ckpt, trainable, shadows = _lightning_ckpt(tt, values)
    assert diffsep_ema_param_order(
        [k for k in ckpt["state_dict"] if k != "score_model.backbone.sigmas"]
    ) == [f"score_model.backbone.{k}" for k in trainable]
    import_diffsep_ema(tt.model, ckpt)
    got = tt.model.backbone.state_dict()
    for k, s in zip(trainable, shadows):
        assert torch.equal(got[k], torch.from_numpy(s)), k
    assert torch.equal(got["all_modules.0.W"],
                       ckpt["state_dict"]["score_model.backbone."
                                          "all_modules.0.W"])
    jax_params = {"backbone": jti.import_diffsep_ema(tmpl["backbone"],
                                                     ckpt)}
    _check_model(tt, jt, jax_params)
    # the file round trip: Lightning's state_dict unwrapped
    torch.save(ckpt, tmp_path / "epoch-029.ckpt")
    flat = load_torch_ckpt(str(tmp_path / "epoch-029.ckpt"))
    jflat = jti.load_torch_ckpt(str(tmp_path / "epoch-029.ckpt"))
    assert list(flat) == list(jflat) == list(ckpt["state_dict"])
    for k, v in flat.items():
        np.testing.assert_array_equal(v, jflat[k])


def test_ema_shadow_count_must_match(pair):
    jt, tmpl, tt, values = pair
    ckpt, trainable, shadows = _lightning_ckpt(tt, values, n_extra_shadows=1)
    with pytest.raises(ValueError, match="shadow list"):
        import_diffsep_ema(tt.model, ckpt)
    with pytest.raises(ValueError, match="shadow list"):
        jti.import_diffsep_ema(tmpl["backbone"], ckpt)


def test_import_ema_params_by_order(pair):
    """torch_ema's list by an explicit order: strict, as JAX's (the
    Fourier W must be named too)."""
    jt, tmpl, tt, values = pair
    ref = _reference_state(values, backbone=False)
    order = list(tt.model.backbone.state_dict())
    import_ema_params(tt.model, [ref[k] * 0.5 for k in order], order)
    jax_params = {"backbone": jti.import_ema_params(
        tmpl["backbone"], [ref[k] * 0.5 for k in order], order)}
    _check_model(tt, jt, jax_params)
    with pytest.raises(KeyError, match="all_modules.0.W"):
        import_ema_params(tt.model, [ref[k] for k in order[1:]], order[1:])


@pytest.mark.parametrize("use_snake", [False, True])
def test_import_oobleck_params_matches_jax(use_snake):
    jm, params, tm = vae_pair(use_snake, seed=3)
    rng = np.random.default_rng(4)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in _flat(params["params"]).items()}
    state = {}
    for k, v in flat.items():
        path = tuple(k.split("/"))
        a = v.transpose(2, 1, 0) if path[-1] == "v" else (
            v.reshape(-1, 1, 1) if path[-1] == "g" else v)
        state["autoencoder." + jti.oobleck_flax_path_to_torch_key(
            path, n_blocks=2)] = a
    state["autoencoder.bottleneck.scale"] = np.ones(1, np.float32)
    jax_params = {"params": jti.import_oobleck_params(
        params["params"], state, prefix="autoencoder.", n_blocks=2)}
    import_oobleck_params(tm, state, prefix="autoencoder.")
    want_state = oobleck_params_from_jax(_flat(jax_params["params"]))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want_state[k]), k
    audio = (0.5 * rng.standard_normal((2, 1, 256))).astype(np.float32)
    encode = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))
    decode = jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))
    want = np.asarray(encode(jax_params, jnp.asarray(audio)))
    got = tm.encode(torch.from_numpy(audio)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    lat = rng.standard_normal((2, 4, 32)).astype(np.float32)
    want = np.asarray(decode(jax_params, jnp.asarray(lat)))
    got = tm.decode(torch.from_numpy(lat)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    del state["autoencoder.encoder.layers.0.weight_g"]
    with pytest.raises(KeyError, match="encoder.layers.0.weight_g"):
        import_oobleck_params(tm, state, prefix="autoencoder.")
