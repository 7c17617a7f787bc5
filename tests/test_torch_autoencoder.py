"""The port's VAE-GAN trainer (``training/autoencoder.py``) against the
JAX package's on the CPU: a tiny OobleckVAE (channels 8, hop 8, latent 4)
and its teacher and a two-scale Encodec discriminator (filters 4), seeded
weights, perturbed, carried across by the bridges; audio made by
numpy from a seed; JAX's draws (the posterior's, the latent mask's and
the teacher's posterior's, ``fold_in(key, 7)``) rebuilt from its key.

Tolerances, stated before the runs: every loss term 1e-4 of |ref| (the
posterior round trip, L1, KL, the latent mask, the teacher's four
distillation terms, the adversarial and feature-matching terms, and
``encoder_freeze_on_warmup``); the generator loss's gradients 1e-3 of
each leaf's max|ref| (the frozen encoder's exactly 0 on both sides); a
gen + disc step pair with the mask, the teacher and the frozen encoder:
each step's gradient leaf by leaf 1e-3 of its max|ref|
(tests/test_torch_ldm.py:check_grads), the parameters at the train-step
bars at the applied rates (tests/test_torch_ldm.py:
step_bars; after one update nothing to add for the explained part), the
EMA the same times (1 - decay) plus 2 ulps, the teacher bit for bit
unchanged.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models.discriminators import (
    discriminator_loss as jax_disc_loss,
)
from ditsep_tpu.models.oobleck import OobleckVAE as JaxVAE
from ditsep_tpu.training.autoencoder import (
    AutoencoderLossConfig as JaxLossConfig,
)
from ditsep_tpu.training.autoencoder import AutoencoderTrainer as JaxAE
from ditsep_tpu_torch.models.discriminators import discriminator_loss
from ditsep_tpu_torch.models.oobleck import OobleckVAE
from ditsep_tpu_torch.models.weights import oobleck_params_from_jax
from ditsep_tpu_torch.training.autoencoder import (
    AutoencoderLossConfig, AutoencoderTrainer,
)
from ditsep_tpu_torch.training.schedules import inverse_lr_schedule
from test_torch_discriminators import _flat, seeded_disc_pair
from test_torch_latent import _unflat
from test_torch_ldm import (
    _check_params, _disc_torch, check_grads, seeded_vae_flat, step_bars,
)

B, T, D, HOP = 2, 512, 4, 8
TL = T // HOP
VAE = dict(channels=8, c_mults=(1, 2), strides=(2, 4), latent_dim=D)
LOSS = dict(fft_sizes=(256, 64), hop_sizes=(64, 16),
            perceptual_weighting=True, sample_rate=8000)
DISC = dict(filters=4, n_ffts=(256, 128), hops=(64, 32))
LR = 1.0  # the warmup's first rates are 1e-3 LR: steps well above ulps


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs (the suite runs files in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def vae_flats():
    """The student's and the teacher's weights, the JAX flat tree."""
    return (seeded_vae_flat(OobleckVAE(**VAE), 5),
            seeded_vae_flat(OobleckVAE(**VAE), 6))


def _port_vae(flat):
    vae = OobleckVAE(**VAE)
    vae.load_state_dict(oobleck_params_from_jax(flat), strict=True)
    return vae


def _pair(disc=True, teacher=False, **kw):
    """(JAX trainer, its VAE params, disc params, the port's trainer), the
    port's modules its own."""
    student, teach = vae_flats()
    jdisc = jparams = tdisc = None
    if disc:
        jdisc, jparams, tdisc = seeded_disc_pair(1, **DISC)
        tdisc = copy.deepcopy(tdisc)
    loss = {**LOSS, **kw.pop("loss", {})}
    jkw, tkw = dict(kw), dict(kw)
    if teacher:
        jkw.update(teacher_vae=JaxVAE(**VAE),
                   teacher_params={"params": _unflat(teach)})
        tkw.update(teacher_vae=_port_vae(teach))
    jt = JaxAE(vae=JaxVAE(**VAE), disc=jdisc,
               loss_cfg=JaxLossConfig(**loss), lr=LR, disc_lr=2 * LR, **jkw)
    tt = AutoencoderTrainer(vae=_port_vae(student), disc=tdisc,
                            loss_cfg=AutoencoderLossConfig(**loss), lr=LR,
                            disc_lr=2 * LR, **tkw)
    return jt, {"params": _unflat(student)}, jparams, tt


def _reals(seed):
    return (0.3 * np.random.default_rng(seed).standard_normal((B, 1, T))
            ).astype(np.float32)


def jax_draws(key, b=B):
    """JAX's draws for ``key`` on a batch of ``b`` in the port's layouts:
    the posterior's and the teacher's normals drawn (b, Tl, D), the mask's
    uniforms (b, D, Tl)."""
    k_enc, k_mask = jax.random.split(key)
    normal = lambda k: np.asarray(  # noqa: E731
        jax.random.normal(k, (b, TL, D))).transpose(0, 2, 1)
    return {"enc_z": normal(k_enc),
            "mask_u": np.asarray(jax.random.uniform(k_mask, (b, D, TL))),
            "teacher_z": normal(jax.random.fold_in(key, 7))}


def _vae_torch(tree):
    return {k: v.numpy() for k, v in oobleck_params_from_jax(
        _flat(tree["params"])).items()}


LOSS_CASES = {
    "plain": (dict(disc=False), True),
    "disc_l1_mask": (dict(loss=dict(l1=1.0), latent_mask_ratio=0.3), True),
    "disc_cold_teacher": (dict(teacher=True), False),
    "freeze": (dict(encoder_freeze_on_warmup=True), True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_gen_loss_terms_and_gradients_match_jax(case):
    kw, warmed = LOSS_CASES[case]
    jt, vae_params, jparams, tt = _pair(**dict(kw))
    key = jax.random.PRNGKey(20)
    reals = _reals(21)
    (total_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jt.gen_loss(p, jparams, key, jnp.asarray(reals), warmed),
        has_aux=True))(vae_params)
    tt.init_state()
    named = dict(tt.vae.named_parameters())
    total_t, aux_t = tt.gen_loss(torch.from_numpy(reals), warmed,
                                 draws=jax_draws(key))
    grads = torch.autograd.grad(total_t, list(named.values()),
                                allow_unused=True)
    want_terms = {"mrstft", "kl"}
    if case == "disc_l1_mask":
        want_terms |= {"l1", "adversarial", "feature_matching"}
    if case == "freeze":
        want_terms |= {"adversarial", "feature_matching"}
    if case == "disc_cold_teacher":
        want_terms |= {"latent_distill", "mrstft_distill",
                       "mrstft_own_latents_teacher",
                       "mrstft_teacher_latents_own"}
    assert set(aux_t) == set(aux_j) == want_terms
    for k, v in [("total", total_t), *aux_t.items()]:
        ref = float(total_j if k == "total" else aux_j[k])
        assert abs(v.item() - ref) <= 1e-4 * abs(ref), (k, v.item(), ref)
    want = _vae_torch(grads_j)
    for (k, p), g in zip(named.items(), grads):
        if case == "freeze" and k.startswith("encoder."):
            assert g is None and not want[k].any(), k
            continue
        w = want[k]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


def test_gen_and_disc_steps_match_jax():
    """A generator step then a discriminator step with the latent mask,
    the teacher and the encoder frozen on warmup, against JAX's."""
    kw = dict(teacher=True, latent_mask_ratio=0.3,
              encoder_freeze_on_warmup=True)
    jt, vae_params, jparams, tt = _pair(**kw)
    st = jt.init_state(vae_params, jparams)
    state = tt.init_state()
    snap = lambda m: {k: v.detach().numpy().copy()  # noqa: E731
                      for k, v in m.state_dict().items()}
    vae0, disc0, teacher0 = (snap(tt.vae), snap(tt.disc),
                             snap(tt.teacher_vae))
    reals = _reals(30)
    key = jax.random.PRNGKey(31)
    draws = jax_draws(key)
    named = dict(tt.vae.named_parameters())
    loss = tt.gen_loss(torch.from_numpy(reals), True, draws=draws)[0]
    grads_t = {k: (np.zeros(p.shape, np.float32) if g is None else g.numpy())
               for (k, p), g in zip(named.items(), torch.autograd.grad(
                   loss, list(named.values()), allow_unused=True))}
    grads_j = jax.jit(jax.grad(lambda p: jt.gen_loss(
        p, st.disc_params, key, jnp.asarray(reals), True)[0]))(st.vae_params)
    check_grads(grads_t, _vae_torch(grads_j), "gen step")
    st, mj = jax.jit(jt.gen_step, static_argnames=("warmed_up",))(
        st, key, jnp.asarray(reals), warmed_up=True)
    state, mt = tt.gen_step(state, torch.from_numpy(reals), True,
                            draws=draws)
    for k in mj:
        ref = float(mj[k])
        assert abs(mt[k].item() - ref) <= 1e-4 * abs(ref), k
    # one update each: Adam's first is g / (|g| + eps), which the two
    # sides' gradient round-off moves only where the gradient is not
    # significant, so the explained part is left out (the port's history
    # on both sides)
    bars = step_bars([grads_t], [grads_t], vae0,
                     [inverse_lr_schedule(LR)(0)], np.inf)
    _check_params(snap(tt.vae), _vae_torch(st.vae_params), bars, "vae")
    ema_want = _vae_torch(st.ema_vae_params)
    d = tt.ema_decay
    _check_params(snap(state.ema_vae), ema_want, {
        k: b * (1 - d) + 2 * np.spacing(np.abs(ema_want[k]))
        for k, b in bars.items()}, "ema")
    for k, v in snap(tt.disc).items():
        assert np.array_equal(v, disc0[k]), k

    key = jax.random.PRNGKey(32)
    draws = jax_draws(key)
    assert tt.use_disc_this_step(1) and jt.use_disc_this_step(1)
    with torch.no_grad():
        dec, r, _, _ = tt._roundtrip(torch.from_numpy(reals), None, draws)
    named = dict(tt.disc.named_parameters())
    gd_t = {k: g.numpy() for k, g in zip(named, torch.autograd.grad(
        discriminator_loss(tt.disc, r, dec)[0], list(named.values())))}
    dec_j, r_j, _, _ = jt._roundtrip(st.vae_params, key, jnp.asarray(reals))
    gd_j = jax.jit(jax.grad(lambda dp: jax_disc_loss(
        jt.disc, dp, r_j, dec_j)[0]))(st.disc_params)
    check_grads(gd_t, _disc_torch(gd_j), "disc step")
    vae1 = snap(tt.vae)
    st, mj = jax.jit(jt.disc_step)(st, key, jnp.asarray(reals))
    state, mt = tt.disc_step(state, torch.from_numpy(reals), draws=draws)
    ref = float(mj["train/discriminator_loss"])
    assert abs(mt["train/discriminator_loss"].item() - ref) <= 1e-4 * abs(ref)
    bars = step_bars([gd_t], [gd_t], disc0,
                     [inverse_lr_schedule(2 * LR)(0)], np.inf)
    _check_params(snap(tt.disc), _disc_torch(st.disc_params), bars, "disc")
    for k, v in snap(tt.vae).items():
        assert np.array_equal(v, vae1[k]), k
    for k, v in snap(tt.teacher_vae).items():
        assert np.array_equal(v, teacher0[k]), k
    assert state.step == 2 == int(st.step)
    assert state.vae_optimizer.count == state.disc_optimizer.count == 1


def test_draws_from_the_generator():
    """Without draws every draw comes from the generator: one seed, one
    loss; another seed, another."""
    losses = []
    for seed in (7, 7, 8):
        _, _, _, tt = _pair(disc=False, teacher=True, latent_mask_ratio=0.3)
        tt.init_state()
        with torch.no_grad():
            losses.append(tt.gen_loss(
                torch.from_numpy(_reals(40)), True,
                generator=torch.Generator().manual_seed(seed))[0])
    assert torch.equal(losses[0], losses[1]) and torch.isfinite(losses[0])
    assert not torch.equal(losses[0], losses[2])


def test_use_disc_this_step_matches_jax():
    for disc, warmup in ((object(), 0), (object(), 3), (None, 0)):
        jt = JaxAE(vae=None, disc=disc, warmup_steps=warmup)
        tt = AutoencoderTrainer(vae=None, disc=disc, warmup_steps=warmup)
        assert [tt.use_disc_this_step(s) for s in range(6)] == [
            jt.use_disc_this_step(s) for s in range(6)]
