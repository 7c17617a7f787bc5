"""The port's latent path (``LatentScoreModelNCSNpp``,
``LatentDiffSepTrainer``) against the JAX package's on the CPU: the same
weights (the VAE through ``oobleck_params_from_jax``, the score model
through ``params_from_jax``), the same inputs made with numpy from a seed,
and JAX's own draws rebuilt from its key splits. The size is
tests/test_cli.py's TINY_LATENT: VAE channels 8, c_mults (1, 2), strides
(2, 4) (hop 8), latent_dim 4; U-Net nf 16, ch_mult (1, 2); 200 samples
give 25 latent frames, not a multiple of max_latent_length 4.

Tolerances, stated before the runs: the score model 1e-4 of max|ref| (the
port's score-model bar); the trainer's encode (the mode) and decode 2e-5
abs (the VAE's), its posterior sample 1e-5 of max|ref|;
``separate_latent`` 1e-3 of max|ref| (the separation path's bar), PC and
ab2, with the NFE equal; ``val_metrics_latent`` 1e-5 dB abs of SI-SDR,
end to end and on the same estimates. The training loss, its
gradients and the train steps are tests/test_torch_latent_train.py's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ditsep_tpu import configs as jax_configs
from ditsep_tpu.training import losses as jax_losses
from ditsep_tpu_torch import configs as tconfigs
from ditsep_tpu_torch.models.weights import (
    oobleck_params_from_jax, params_from_jax,
)
from ditsep_tpu_torch.training import losses as tlosses
from test_torch_samplers import ab2_draws
from test_torch_train import jax_draws

TINY = {
    "model.score_model.nf": 16,
    "model.score_model.ch_mult": (1, 2),
    "model.score_model.attn_resolutions": (),
    "model.score_model.image_size": 4,
    "model.vae.channels": 8,
    "model.vae.c_mults": (1, 2),
    "model.vae.strides": (2, 4),
    "model.vae.latent_dim": 4,
}
LENGTH, HOP, D = 200, 8, 4
TL = -(-LENGTH // HOP)  # 25
B = 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturbed_flat(tree, scale, seed):
    rng = np.random.default_rng(seed)
    return {"/".join(str(getattr(k, "key", k)) for k in kp):
            (np.array(leaf) + scale * rng.standard_normal(leaf.shape)
             ).astype(np.float32)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unflat(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                           for k, a in flat.items()})


@functools.lru_cache(maxsize=None)
def tiny_latent_pair(mask_padding=False, seed=2):
    """The JAX and port latent trainers on the tiny config with the same
    VAE and score-model weights (JAX-initialised, perturbed so that every
    leaf counts). Returns (JAX trainer, score params, VAE params, port
    trainer); shared by the tests that read them only."""
    ov = {**TINY, "model.score_model.mask_padding": mask_padding}
    jt = jax_configs.build_latent_trainer(jax_configs.override(
        jax_configs.latent_diffsep_ouve(), ov))
    tt = tconfigs.build_latent_trainer(tconfigs.override(
        tconfigs.latent_diffsep_ouve(), ov), device="cpu")
    vflat = _perturbed_flat(jax.jit(jt.vae.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 1, 64)))["params"], 0.1, seed)
    vae_params = {"params": _unflat(vflat)}
    tt.vae.load_state_dict(oobleck_params_from_jax(vflat), strict=True)
    mix_lat, tgt_lat = jt.encode(vae_params, None, jnp.zeros((1, 1, LENGTH)),
                                 jnp.zeros((1, 2, LENGTH)))
    flat = _perturbed_flat(jax.jit(jt.model.init)(
        jax.random.PRNGKey(0), tgt_lat, jnp.full((1,), 0.5),
        mix_lat)["params"], 0.05, seed + 1)
    tt.model.load_state_dict(params_from_jax(flat), strict=True)
    return jt, {"params": _unflat(flat)}, vae_params, tt


def _batch(seed=3, length=LENGTH):
    rng = np.random.default_rng(seed)
    tgt = (0.3 * rng.standard_normal((B, 2, length))).astype(np.float32)
    tgt[:, 1] *= 0.5
    return tgt.sum(1, keepdims=True), tgt


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def enc_draws(key, b, n):
    """JAX encode's posterior draws for ``key``: split into (mixture,
    targets), each drawn in its (B, Tl, D) layout, as (B, D, Tl)."""
    k1, k2 = jax.random.split(key)
    return {"enc_mix_z": _normal(k1, (b, TL, D)).transpose(0, 2, 1),
            "enc_tgt_z": _normal(k2, (b * n, TL, D)).transpose(0, 2, 1)}


def latent_loss_draws(cfg, key, b=B, n=2):
    """Every draw of JAX's training_loss_latent(key): (encode, loss)."""
    k_enc, k_loss = jax.random.split(key)
    return {**enc_draws(k_enc, b, n), **jax_draws(cfg, k_loss, b, n, D, TL)}


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("mode", ["plain", "masked", "lengths"])
def test_latent_score_model_matches_jax(mode):
    jt, params, _, tt = tiny_latent_pair(mask_padding=mode != "plain")
    rng = np.random.default_rng(5)
    tl = 13  # padded to 16 inside the model
    xt = rng.standard_normal((3, 2, D, tl)).astype(np.float32)
    mix = rng.standard_normal((3, 1, D, tl)).astype(np.float32)
    t = np.array([0.9, 0.4, 0.05], np.float32)
    lens = np.array([13, 9, 5], np.int32) if mode == "lengths" else None
    kw = {} if lens is None else {"lengths": jnp.asarray(lens)}
    want = jax.jit(jt.model.apply)(params, jnp.asarray(xt), jnp.asarray(t),
                                   jnp.asarray(mix), **kw)
    kw = {} if lens is None else {"lengths": torch.from_numpy(lens)}
    got = tt.model(torch.from_numpy(xt), torch.from_numpy(t),
                   torch.from_numpy(mix), **kw)
    assert got.dtype == torch.float32 and got.shape == (3, 2, D, tl)
    _close(got, want, 1e-4)


def test_encode_and_decode_match_jax():
    jt, _, vae_params, tt = tiny_latent_pair()
    mix, tgt = _batch()
    encode = jax.jit(jt.encode)
    jm, jtg = encode(vae_params, None, jnp.asarray(mix), jnp.asarray(tgt))
    tm, ttg = tt.encode(torch.from_numpy(mix), torch.from_numpy(tgt))
    assert tm.shape == (B, 1, D, TL) and ttg.shape == (B, 2, D, TL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ttg.numpy(), np.asarray(jtg), atol=2e-5,
                               rtol=0)
    key = jax.random.PRNGKey(4)  # the posterior sample
    jm, jtg = encode(vae_params, key, jnp.asarray(mix), jnp.asarray(tgt))
    tm, ttg = tt.encode(torch.from_numpy(mix), torch.from_numpy(tgt),
                        draws=enc_draws(key, B, 2))
    _close(tm, jm, 1e-5)
    _close(ttg, jtg, 1e-5)
    est = np.random.default_rng(6).standard_normal((B, 2, D, TL)).astype(
        np.float32)
    want = jax.jit(jt.decode, static_argnums=2)(vae_params, jnp.asarray(est),
                                                 LENGTH - 3)
    got = tt.decode(torch.from_numpy(est), LENGTH - 3)
    assert got.shape == (B, 2, LENGTH - 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def _sampler_noise(key, n):
    """pc_sample's draws for ``key``: the prior, each step's corrector and
    predictor (tests/test_torch_samplers_model.py)."""
    shape = (B, 2, D, TL)
    key, k_prior = jax.random.split(key)
    keys = jax.random.split(key, 2 * n).reshape(n, 2, -1)
    return (_normal(k_prior, shape),
            np.stack([[_normal(jax.random.split(k[0])[0], shape)]
                      for k in keys]),
            np.stack([_normal(k[1], shape) for k in keys]))


@pytest.mark.parametrize("sampler", ["pc", "ab2"])
def test_separate_latent_matches_jax(sampler):
    jt, params, vae_params, tt = tiny_latent_pair()
    mix, _ = _batch(seed=8)
    n = 3
    rng = np.random.default_rng(9)
    enc = rng.standard_normal((B, D, TL)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    if sampler == "pc":
        noise = tuple(a.astype(np.float32) for a in (
            rng.standard_normal((B, 2, D, TL)),
            rng.standard_normal((n, 1, B, 2, D, TL)),
            rng.standard_normal((n, B, 2, D, TL))))
        jkw = {"noise": tuple(jnp.asarray(a) for a in noise)}
    else:  # JAX's ab2 draws its prior from the sampling key
        noise = ab2_draws(jax.random.split(key)[1], n, (B, 2, D, TL), False)
        jkw = {}
    want, jnfe = jax.jit(lambda p, vp, k, m, e, kw: jt.separate_latent(
        p, vp, k, m, target_dim=LENGTH - 5, N=n, enc_noise=e,
        sampler=sampler, **kw))(params, vae_params, key, jnp.asarray(mix),
                                jnp.asarray(enc), jkw)
    got, tnfe = tt.separate_latent(torch.from_numpy(mix),
                                   target_dim=LENGTH - 5, N=n,
                                   enc_noise=enc, sampler=sampler,
                                   noise=noise)
    assert tnfe == int(jnfe) == (2 * n if sampler == "pc" else n)
    assert got.shape == (B, 2, LENGTH - 5)
    _close(got, want, 1e-3)


def test_val_metrics_latent_matches_jax():
    """End to end with matched draws, and the metric alone (zero_mean=False,
    clamp 30 dB) on the same estimates, each within 1e-5 dB."""
    jt, params, vae_params, tt = tiny_latent_pair()
    mix, tgt = _batch(seed=10)
    n = 2
    rng = np.random.default_rng(13)
    enc = rng.standard_normal((B, D, TL)).astype(np.float32)
    noise = _sampler_noise(jax.random.PRNGKey(14), n)
    want = jax.jit(lambda p, vp, k, b, e, z: jt.val_metrics_latent(
        p, vp, k, b, N=n, enc_noise=e, noise=z))(
        params, vae_params, jax.random.PRNGKey(15),
        (jnp.asarray(mix), jnp.asarray(tgt)), jnp.asarray(enc),
        tuple(jnp.asarray(a) for a in noise))["val/si_sdr"]
    got = tt.val_metrics_latent(tt.model, (torch.from_numpy(mix),
                                           torch.from_numpy(tgt)),
                                N=n, enc_noise=enc, noise=noise)["val/si_sdr"]
    assert abs(got.item() - float(want)) <= 1e-5
    est = np.random.default_rng(16).standard_normal(tgt.shape).astype(
        np.float32) + tgt
    want = jax_losses.si_sdr_loss(jnp.asarray(est), jnp.asarray(tgt),
                                  zero_mean=False, clamp_db=30.0)
    got = tlosses.si_sdr_loss(torch.from_numpy(est), torch.from_numpy(tgt),
                              zero_mean=False, clamp_db=30.0)
    assert abs(got.item() - float(want)) <= 1e-5


def main():
    """Print how far inside its bar each comparison lands, one JSON line a
    comparison (PERF.md's parity table):

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_latent.py
    """
    import json

    from test_torch_oobleck import LD, _audio, vae_pair

    def report(module, got, want, relative):
        got, want = np.asarray(got), np.asarray(want)
        err = float(np.abs(got - want).max())
        if relative:
            err /= float(np.abs(want).max())
        print(json.dumps({"module": module, "max_err": err,
                          "relative_to_max_ref": relative}))

    lat = np.random.default_rng(2).standard_normal((2, LD, 32)).astype(
        np.float32)
    for snake in (False, True):
        jm, params, tm = vae_pair(snake)
        audio = _audio()
        with torch.no_grad():
            report(f"OobleckVAE.encode (mode), snake={snake}",
                   tm.encode(torch.from_numpy(audio)),
                   jm.apply(params, jnp.asarray(audio), method=jm.encode),
                   False)
            report(f"OobleckVAE.decode, snake={snake}",
                   tm.decode(torch.from_numpy(lat)),
                   jm.apply(params, jnp.asarray(lat), method=jm.decode),
                   False)
    jt, params, vae_params, tt = tiny_latent_pair()
    rng = np.random.default_rng(5)
    xt = rng.standard_normal((3, 2, D, 13)).astype(np.float32)
    mix = rng.standard_normal((3, 1, D, 13)).astype(np.float32)
    t = np.array([0.9, 0.4, 0.05], np.float32)
    with torch.no_grad():
        report("LatentScoreModelNCSNpp (Tl 13)",
               tt.model(torch.from_numpy(xt), torch.from_numpy(t),
                        torch.from_numpy(mix)),
               jax.jit(jt.model.apply)(params, jnp.asarray(xt),
                                       jnp.asarray(t), jnp.asarray(mix)),
               True)
    mix, _ = _batch(seed=8)
    n = 3
    enc = rng.standard_normal((B, D, TL)).astype(np.float32)
    noise = tuple(a.astype(np.float32) for a in (
        rng.standard_normal((B, 2, D, TL)),
        rng.standard_normal((n, 1, B, 2, D, TL)),
        rng.standard_normal((n, B, 2, D, TL))))
    want, _ = jax.jit(lambda p, vp, k, m, e, z: jt.separate_latent(
        p, vp, k, m, target_dim=LENGTH, N=n, enc_noise=e, noise=z))(
        params, vae_params, jax.random.PRNGKey(0), jnp.asarray(mix),
        jnp.asarray(enc), tuple(jnp.asarray(a) for a in noise))
    got, _ = tt.separate_latent(torch.from_numpy(mix), target_dim=LENGTH,
                                N=n, enc_noise=enc, noise=noise)
    report("LatentDiffSepTrainer.separate_latent (PC, N=3)", got, want, True)


if __name__ == "__main__":
    main()
