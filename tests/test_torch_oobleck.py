"""The port's OobleckVAE (ditsep_tpu_torch/models/oobleck.py) against the
JAX package's on the CPU, with the same weights carried across by the VAE
weight bridge (``oobleck_params_from_jax``), at the tiny size of
tests/test_oobleck.py (channels 8, c_mults (1, 2), strides (2, 4), latent
64 -> 4; hop 8).

Tolerances, stated before the runs: encode (the mode) and decode 2e-5
abs, the JAX package's own bar against its torch oracle
(tests/test_oobleck.py:140,152); the posterior sample with an injected
draw, and its KL, 1e-5 of max|ref|; the conv lengths exact; the bridge's
round trip bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import oobleck as joob
from ditsep_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from ditsep_tpu.utils.checkpoint import save_params_npz as jax_save_npz
from ditsep_tpu_torch.models import oobleck as toob
from ditsep_tpu_torch.models.weights import (
    load_params_npz, oobleck_params_from_jax, oobleck_params_to_jax,
    save_params_npz,
)

CH, CM, ST, LD = 8, (1, 2), (2, 4), 4
HOP = 8


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unflat(flat):
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _perturbed(params, seed):
    """JAX-initialised parameters moved off their init (g off ||v||,
    non-zero biases and SnakeBeta alpha / beta), so that every leaf counts."""
    rng = np.random.default_rng(seed)
    return {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in _flat(params).items()}


def vae_pair(use_snake=False, seed=0):
    """(JAX module, its params, the port's VAE with the same weights)."""
    jm = joob.OobleckVAE(channels=CH, c_mults=CM, strides=ST, latent_dim=LD,
                         use_snake=use_snake)
    tmpl = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1, 64)))
    flat = _perturbed(tmpl["params"], seed)
    tm = toob.OobleckVAE(channels=CH, c_mults=CM, strides=ST, latent_dim=LD,
                         use_snake=use_snake)
    tm.load_state_dict(oobleck_params_from_jax(flat), strict=True)
    return jm, {"params": _unflat(flat)}, tm.eval()


def _audio(b=2, t=256, seed=1):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((b, 1, t))).astype(np.float32)


@pytest.mark.parametrize("use_snake", [False, True])
def test_encode_mode_and_decode_match_jax(use_snake):
    jm, params, tm = vae_pair(use_snake)
    audio = _audio()
    want = np.asarray(jm.apply(params, jnp.asarray(audio), method=jm.encode))
    got = tm.encode(torch.from_numpy(audio)).detach().numpy()
    assert got.shape == want.shape == (2, LD, 256 // HOP)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    lat = np.random.default_rng(2).standard_normal((2, LD, 32)).astype(
        np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(lat), method=jm.decode))
    got = tm.decode(torch.from_numpy(lat)).detach().numpy()
    assert got.shape == want.shape == (2, 1, 32 * HOP)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_posterior_sample_and_kl_match_jax():
    jm, params, tm = vae_pair()
    audio = _audio(seed=3)
    z = np.random.default_rng(4).standard_normal((2, LD, 32)).astype(
        np.float32)
    want, info = jm.apply(params, jnp.asarray(audio), noise=jnp.asarray(z),
                          return_info=True, method=jm.encode)
    with torch.no_grad():
        got, tinfo = tm.encode(torch.from_numpy(audio),
                               noise=torch.from_numpy(z), return_info=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    kl = float(info["kl"])
    assert kl > 0
    assert abs(float(tinfo["kl"]) - kl) <= 1e-5 * abs(kl)
    for k in ("mean", "scale"):
        ref = np.asarray(info[k])
        np.testing.assert_allclose(tinfo[k].detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_generator_draw_is_a_posterior_sample():
    """With a generator the latents are mean + stdev * z, z drawn from it."""
    _, _, tm = vae_pair()
    audio = torch.from_numpy(_audio(seed=5))
    lat = tm.encode(audio, generator=torch.Generator().manual_seed(3))
    _, info = tm.encode(audio, return_info=True)
    z = torch.randn(info["mean"].shape, generator=torch.Generator()
                    .manual_seed(3))
    want, _ = toob.vae_sample(info["mean"], info["scale"], z)
    assert torch.equal(lat, want)
    assert float(info["kl"]) == 0.0


@pytest.mark.parametrize("s", [2, 4, 8])
def test_conv_lengths_and_values_match_jax(s):
    """The strided conv gives T / s samples and the transposed conv
    exactly T * s, as the JAX modules, with the same values."""
    rng = np.random.default_rng(s)
    t = 64
    x = rng.standard_normal((2, t, 6)).astype(np.float32)  # NWC
    for jmod, tmod, x_in in (
            (joob.WNConv1d(5, 2 * s, stride=s, padding=-(-s // 2)),
             toob.WNConv1d(6, 5, 2 * s, stride=s, padding=-(-s // 2)), x),
            (joob.WNConvTranspose1d(5, 2 * s, stride=s, padding=-(-s // 2)),
             toob.WNConvTranspose1d(6, 5, 2 * s, stride=s,
                                    padding=-(-s // 2)), x)):
        tmpl = jmod.init(jax.random.PRNGKey(s), jnp.asarray(x_in))
        flat = _perturbed(tmpl["params"], s)
        want = np.asarray(jmod.apply({"params": _unflat(flat)},
                                     jnp.asarray(x_in)))
        # the bridge's leaf layouts, on a one-module tree
        state = oobleck_params_from_jax(
            {f"encoder/stem/{k}": v for k, v in flat.items()})
        tmod.load_state_dict({k.split(".")[-1]: v
                              for k, v in state.items()}, strict=True)
        got = tmod(torch.from_numpy(x_in.transpose(0, 2, 1))).detach()
        got = got.numpy().transpose(0, 2, 1)
        want_len = t // s if isinstance(tmod, toob.WNConv1d) else t * s
        assert got.shape == want.shape == (2, want_len, 5)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_nearest_upsample_decoder_matches_jax():
    """The nearest-upsample decoder pads its k = 2s conv (s - 1, s): exactly
    Tl * hop samples, the JAX decoder's values."""
    jd = joob.OobleckDecoder(channels=CH, latent_dim=LD, c_mults=CM,
                             strides=ST, use_nearest_upsample=True)
    lat = np.random.default_rng(6).standard_normal((2, 16, LD)).astype(
        np.float32)
    tmpl = jd.init(jax.random.PRNGKey(1), jnp.asarray(lat))
    flat = _perturbed(tmpl["params"], 1)
    want = np.asarray(jd.apply({"params": _unflat(flat)}, jnp.asarray(lat)))
    td = toob.OobleckDecoder(channels=CH, latent_dim=LD, c_mults=CM,
                             strides=ST, use_nearest_upsample=True)
    state = oobleck_params_from_jax({f"decoder/{k}": v
                                     for k, v in flat.items()})
    td.load_state_dict({k[len("decoder."):]: v for k, v in state.items()},
                       strict=True)
    got = td(torch.from_numpy(lat.transpose(0, 2, 1))).detach().numpy()
    assert got.shape == (2, 1, 16 * HOP)
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("use_snake", [False, True])
def test_bridge_round_trip_is_bit_equal(use_snake):
    jm = joob.OobleckVAE(channels=CH, c_mults=CM, strides=ST, latent_dim=LD,
                         use_snake=use_snake)
    flat = _perturbed(jm.init(jax.random.PRNGKey(2),
                              jnp.zeros((1, 1, 64)))["params"], 2)
    tm = toob.OobleckVAE(channels=CH, c_mults=CM, strides=ST, latent_dim=LD,
                         use_snake=use_snake)
    tm.load_state_dict(oobleck_params_from_jax(flat), strict=True)
    back = oobleck_params_to_jax(tm)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


def test_npz_files_cross_between_packages(tmp_path):
    """The JAX package's --vae-params file loads into the port, and the
    port's export into the JAX package, unchanged."""
    jm, params, tm = vae_pair(seed=3)
    jax_save_npz(str(tmp_path / "jax.npz"), params)  # 'params/...' keys
    port = toob.OobleckVAE(channels=CH, c_mults=CM, strides=ST,
                           latent_dim=LD)
    load_params_npz(str(tmp_path / "jax.npz"), port)
    for k, v in tm.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    save_params_npz(str(tmp_path / "port.npz"), port)
    back = jax_load_npz(str(tmp_path / "port.npz"), params["params"])
    for k, v in _flat(back).items():
        assert np.array_equal(v, _flat(params["params"])[k]), k


def test_reference_layout_state_dict_loads():
    """A state_dict of the reference's nn.Sequential layout with torch's
    weight_norm (tests/test_oobleck.py's oracle) loads with
    load_state_dict, and the port then computes what that module does."""
    from test_oobleck import _TorchOobleck
    torch.manual_seed(0)
    ref = _TorchOobleck().eval()
    state = {k: v for k, v in ref.state_dict().items()
             if "parametrizations" not in k}
    tm = toob.OobleckVAE(channels=CH, c_mults=CM, strides=ST, latent_dim=LD)
    tm.load_state_dict(state, strict=True)
    audio = torch.from_numpy(_audio(seed=7))
    lat = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, LD, 32)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(tm.encode(audio), ref.encode_mode(audio),
                                   atol=2e-5, rtol=0)
        torch.testing.assert_close(tm.decode(lat), ref.decode(lat),
                                   atol=2e-5, rtol=0)
