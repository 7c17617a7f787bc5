"""The port's LDM decoder finetune (``training/ldm.py``) against the JAX
package's on the CPU, on tests/test_torch_latent.py's tiny latent config
(VAE channels 8, hop 8, latent 4) with a two-scale Encodec discriminator
(filters 4): seeded weights, perturbed, carried across by the bridges;
latents and targets made by numpy from a seed.

Tolerances, stated before the runs: ``decode_grad`` equal to ``decode``
bit for bit, with a ``grad_fn``; ``gen_loss`` and each of its terms
(no discriminator; discriminator warmed up and not; L1 / L2 on) 1e-4 of
|ref|; the steps gen -> disc -> gen against JAX's optax: losses 1e-4
relative, each step's gradient leaf by leaf 1e-3 of its max|ref|
(``check_grads``), and tests/test_torch_train_step.py's bars at the rates the
schedule applied (after its steps a parameter within the sum of 1e-3 *
rate where its gradient is significant, 2 * rate elsewhere) plus twice
the part the two sides' gradients explain through float64 clip + AdamW;
the EMA the same times (1 - decay) plus 2 ulps; the encoder, the score
model and (across a generator step) the discriminator bit for bit
unchanged, and no ``.grad`` left on the discriminator;
``use_disc_this_step`` JAX's over
steps 0-5 for warmup_mode 'full' and 'adv'.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu import configs as jax_configs
from ditsep_tpu.models.discriminators import (
    encodec_discriminator_loss as jax_disc_loss,
)
from ditsep_tpu.training.ldm import LDMLossWeights as JaxWeights
from ditsep_tpu.training.ldm import LDMTrainer as JaxLDM
from ditsep_tpu_torch import configs as tconfigs
from ditsep_tpu_torch.models.discriminators import (
    encodec_discriminator_loss,
)
from ditsep_tpu_torch.models.oobleck import OobleckVAE
from ditsep_tpu_torch.models.weights import (
    disc_params_from_jax, oobleck_params_from_jax, oobleck_params_to_jax,
)
from ditsep_tpu_torch.training.ldm import LDMLossWeights, LDMTrainer
from ditsep_tpu_torch.training.schedules import inverse_lr_schedule
import stable_train_parity
from stable_train_parity import check_grads
from stable_train_parity import check_params as _check_params
from test_torch_discriminators import _flat, seeded_disc_pair
from test_torch_latent import D, TINY, _unflat

B, TL = 2, 64
T = TL * 8  # the tiny VAE's hop
LR = 1.0  # the warmup's first rates are 1e-3 LR: steps well above ulps
WEIGHTS = dict(fft_sizes=(256, 128, 64), hop_sizes=(64, 32, 16),
               perceptual_weighting=True, sample_rate=8000)
DISC = dict(filters=4, n_ffts=(256, 128), hops=(64, 32))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((B, 2, D, TL)).astype(np.float32)
    reals = (0.3 * rng.standard_normal((B, 2, T))).astype(np.float32)
    return lat, reals


def seeded_vae_flat(vae, seed, scale=0.1):
    """``vae``'s weights seeded, perturbed by ``scale`` normals so that
    every leaf counts (the snake's zero-init too), as the JAX package's
    flat tree (no JAX init: its tracing takes seconds)."""
    vae.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in oobleck_params_to_jax(vae).items()}


@functools.lru_cache(maxsize=None)
def tiny_vae_pair():
    """The JAX latent trainer on tests/test_torch_latent.py's tiny config
    and the VAE weights for both sides; the score models are not used by
    the finetune."""
    jt = jax_configs.build_latent_trainer(jax_configs.override(
        jax_configs.latent_diffsep_ouve(), TINY))
    vflat = seeded_vae_flat(OobleckVAE(**{
        k.split(".")[-1]: v for k, v in TINY.items()
        if k.startswith("model.vae.")}), seed=1)
    return jt, {"params": _unflat(vflat)}, vflat


def _pair(disc=True, fresh=False, **kw):
    """A pair of LDM trainers: (JAX trainer, VAE params, disc params, port
    trainer); ``fresh``: the port's discriminator a copy of its own (a
    step updates it in place)."""
    jt, vae_params, vflat = tiny_vae_pair()
    tt = tconfigs.build_latent_trainer(tconfigs.override(
        tconfigs.latent_diffsep_ouve(), TINY), device="cpu")
    tt.vae.load_state_dict(oobleck_params_from_jax(vflat), strict=True)
    jdisc = jparams = tdisc = None
    if disc:
        jdisc, jparams, tdisc = seeded_disc_pair(2, **DISC)
        if fresh:
            tdisc = copy.deepcopy(tdisc)
    w = {**WEIGHTS, **kw.pop("weights", {})}
    jldm = JaxLDM(latent_trainer=jt, disc=jdisc, weights=JaxWeights(**w),
                  lr=LR, **kw)
    tldm = LDMTrainer(latent_trainer=tt, disc=tdisc,
                      weights=LDMLossWeights(**w), lr=LR, **kw)
    return jldm, vae_params, jparams, tldm


def _decoder_torch(dec_tree):
    """The JAX decoder subtree -> the port's ``decoder.``-prefixed keys."""
    return {k: v.numpy() for k, v in oobleck_params_from_jax(
        {f"decoder/{k}": v for k, v in _flat(dec_tree).items()}).items()}


def _disc_torch(tree):
    """A JAX discriminator tree ({"params": ...}) -> the port's keys."""
    return {k: v.numpy()
            for k, v in disc_params_from_jax(_flat(tree["params"])).items()}


def test_decode_grad_equals_decode_and_has_a_graph():
    tt = tconfigs.build_latent_trainer(tconfigs.override(
        tconfigs.latent_diffsep_ouve(), TINY), device="cpu")
    tt.vae.decoder.requires_grad_(True)
    lat, _ = _inputs(1)
    est = torch.from_numpy(lat)
    with_grad = tt.decode_grad(est, T - 5)
    plain = tt.decode(est, T - 5)
    assert torch.equal(with_grad, plain) and with_grad.shape == (B, 2, T - 5)
    assert with_grad.grad_fn is not None and plain.grad_fn is None


GEN_CASES = {
    "no_disc": (dict(disc=False), True),
    "disc_warm": ({}, True),
    "disc_cold": ({}, False),
    "l1_l2": (dict(disc=False, weights=dict(l1=1.0, l2=0.5)), True),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_gen_loss_matches_jax(case):
    kw, warmed = GEN_CASES[case]
    jldm, vae_params, jparams, tldm = _pair(**dict(kw))
    frozen, dec = jldm.split_vae_params(vae_params)
    lat, reals = _inputs(2)
    total_j, aux_j = jax.jit(jldm.gen_loss, static_argnums=5)(
        dec, jparams, frozen, jnp.asarray(lat), jnp.asarray(reals), warmed)
    with torch.no_grad():
        total_t, aux_t = tldm.gen_loss(torch.from_numpy(lat),
                                       torch.from_numpy(reals), warmed)
    assert set(aux_t) == set(aux_j)
    want_keys = {"pit_mrstft_loss", "decoded_std"}
    if case == "disc_warm":
        want_keys |= {"loss_adv", "feature_matching_loss"}
    if case == "l1_l2":
        want_keys |= {"pit_l1_loss", "pit_l2_loss"}
    assert set(aux_t) == want_keys
    for k, v in [("total", total_t), *aux_t.items()]:
        ref = float(total_j if k == "total" else aux_j[k])
        assert abs(v.item() - ref) <= 1e-4 * abs(ref), (k, v.item(), ref)


def step_bars(hist_t, hist_j, p0, rates, clip):
    """tests/stable_train_parity.py's bars at ClipAdamW's settings (b1 0.8,
    b2 0.99, wd 1e-3) and the clip ``clip``."""
    return stable_train_parity.step_bars(hist_t, hist_j, p0, rates,
                                         clip=clip, b1=0.8, b2=0.99, wd=1e-3)


def test_gen_disc_gen_steps_match_jax():
    jldm, vae_params, jparams, tldm = _pair(
        fresh=True, weights=dict(fft_sizes=(256, 64), hop_sizes=(64, 16)))
    tt = tldm.latent_trainer
    frozen, dec0 = jldm.split_vae_params(vae_params)
    st = jldm.init_state(vae_params, jparams)
    state = tldm.init_state()
    trainable = {id(p) for p in tt.model.parameters()
                 if p.requires_grad} | {id(p) for p in tt.vae.parameters()
                                        if p.requires_grad}
    assert trainable == {id(p) for p in tt.vae.decoder.parameters()}
    enc0 = {k: v.clone() for k, v in tt.vae.encoder.state_dict().items()}
    model0 = {k: v.clone() for k, v in tt.model.state_dict().items()}
    snap = lambda m: {k: v.detach().numpy().copy()  # noqa: E731
                      for k, v in m.state_dict().items()}
    dec_p0 = {f"decoder.{k}": v for k, v in snap(tt.vae.decoder).items()}
    disc_p0 = snap(tldm.disc)
    gen_j = jax.jit(jldm.gen_step, static_argnames=("warmed_up",))
    disc_j = jax.jit(jldm.disc_step)
    gen_grad_j = jax.jit(jax.grad(lambda dp, gp, lt, r: jldm.gen_loss(
        dp, gp, frozen, lt, r, True)[0]))
    disc_grad_j = jax.jit(jax.grad(lambda gp, dp, lt, r: jax_disc_loss(
        jldm.disc, gp, r, jldm.decode_with(frozen, dp, lt, r.shape[-1]))[0]))
    named_dec = dict(tt.vae.decoder.named_parameters())
    named_disc = dict(tldm.disc.named_parameters())
    gen_rate = inverse_lr_schedule(LR)
    disc_rate = inverse_lr_schedule(2 * LR)
    hist = {"gen_t": [], "gen_j": [], "disc_t": [], "disc_j": []}
    for n, kind in enumerate(("gen", "disc", "gen")):
        lat, reals = _inputs(10 + n)
        lj, rj = jnp.asarray(lat), jnp.asarray(reals)
        lt, rt = torch.from_numpy(lat), torch.from_numpy(reals)
        assert tldm.use_disc_this_step(n) == jldm.use_disc_this_step(n) == (
            kind == "disc")
        if kind == "gen":
            hist["gen_j"].append(_decoder_torch(gen_grad_j(
                st.decoder_params, st.disc_params, lj, rj)))
            with torch.enable_grad():
                loss = tldm.gen_loss(lt, rt, True)[0]
                grads = torch.autograd.grad(loss, list(named_dec.values()))
            hist["gen_t"].append({f"decoder.{k}": g.numpy()
                                  for k, g in zip(named_dec, grads)})
            disc_before = snap(tldm.disc)
            st, mj = gen_j(st, frozen, lj, rj, warmed_up=True)
            state, mt = tldm.gen_step(state, lt, rt)
            for k, v in snap(tldm.disc).items():
                assert np.array_equal(v, disc_before[k]), k
            assert all(p.grad is None for p in tldm.disc.parameters())
            for k in ("train/loss", "train/pit_mrstft_loss",
                      "train/loss_adv", "train/feature_matching_loss",
                      "train/decoded_std"):
                ref = float(mj[k])
                assert abs(mt[k].item() - ref) <= 1e-4 * abs(ref), k
        else:
            hist["disc_j"].append(_disc_torch(disc_grad_j(
                st.disc_params, st.decoder_params, lj, rj)))
            decoded = tt.decode(lt, T)
            with torch.enable_grad():
                loss = encodec_discriminator_loss(tldm.disc, rt, decoded)[0]
                grads = torch.autograd.grad(loss, list(named_disc.values()))
            hist["disc_t"].append({k: g.numpy()
                                   for k, g in zip(named_disc, grads)})
            dec_before = snap(tt.vae.decoder)
            st, mj = disc_j(st, frozen, lj, rj)
            state, mt = tldm.disc_step(state, lt, rt)
            for k, v in snap(tt.vae.decoder).items():
                assert np.array_equal(v, dec_before[k]), k
            ref = float(mj["train/discriminator_loss"])
            assert abs(mt["train/discriminator_loss"].item() - ref) <= (
                1e-4 * abs(ref))
        assert state.step == n + 1 == int(st.step)
        check_grads(hist[f"{kind}_t"][-1], hist[f"{kind}_j"][-1],
                    f"{kind} step {n}")
        n_gen, n_disc = len(hist["gen_t"]), len(hist["disc_t"])
        assert state.gen_optimizer.count == n_gen
        assert state.disc_optimizer.count == n_disc
        bars = step_bars(hist["gen_t"], hist["gen_j"], dec_p0,
                         [gen_rate(i) for i in range(n_gen)], 1.0)
        got = {f"decoder.{k}": v for k, v in snap(tt.vae.decoder).items()}
        _check_params(got, _decoder_torch(st.decoder_params), bars,
                      "decoder")
        ema_want = _decoder_torch(st.ema_decoder_params)
        ema_got = {f"decoder.{k}": v
                   for k, v in snap(state.ema_decoder).items()}
        d = tldm.ema_decay
        _check_params(ema_got, ema_want, {
            k: b * (1 - d) + 2 * np.spacing(np.abs(ema_want[k]))
            for k, b in bars.items()}, "ema")
        if n_disc:
            bars = step_bars(hist["disc_t"], hist["disc_j"], disc_p0,
                             [disc_rate(i) for i in range(n_disc)], 1.0)
            _check_params(snap(tldm.disc), _disc_torch(st.disc_params),
                          bars, "disc")
    for k, v in tt.vae.encoder.state_dict().items():
        assert torch.equal(v, enc0[k]), k
    for k, v in tt.model.state_dict().items():
        assert torch.equal(v, model0[k]), k
    assert set(state.state_dict()) == {"step", "decoder", "gen_optimizer",
                                       "ema_decoder", "disc",
                                       "disc_optimizer"}


@pytest.mark.parametrize("mode", ["full", "adv"])
def test_use_disc_this_step_matches_jax(mode):
    """The schedule reads only the discriminator's presence and the
    warmup."""
    for disc in (object(), None):
        kw = dict(latent_trainer=None, disc=disc, warmup_steps=2,
                  warmup_mode=mode)
        jldm, tldm = JaxLDM(**kw), LDMTrainer(**kw)
        got = [tldm.use_disc_this_step(s) for s in range(6)]
        assert got == [jldm.use_disc_this_step(s) for s in range(6)]
        assert got == ([False] * 6 if disc is None else
                       [False, False, False, True, False, True]
                       if mode == "full" else [False, True] * 3)
