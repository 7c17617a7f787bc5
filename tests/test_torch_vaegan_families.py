"""The port's VAE-GAN trainer (``training/autoencoder.py``) with the new
discriminator families and config-built optimizers against the JAX
package's on the CPU: the tiny OobleckVAE of tests/test_torch_autoencoder
.py, a DAC discriminator of one two-band MRD (its MPD and MSD, 1024
channels wide, are held in tests/test_torch_disc_families.py) and an
Oobleck one,
JAX's parameters redrawn from a seed and carried over by the bridges,
JAX's draws rebuilt from its keys.

Bars, stated before the runs: a generator step then a discriminator step,
with ``optimizer_configs`` (``vae_tx`` / ``disc_tx`` from
``create_optimizer_from_config``: AdamW under an exponential and a linear
schedule) and the VAE's clip at a norm below its gradient's, or with the
default optimizers: each step's loss terms 1e-4 of |ref|, its gradient
leaf by leaf 1e-3 of max|ref| (with the Oobleck discriminator's hinge,
at least 1e-4 of the largest leaf's, as tests/test_torch_auraloss.py:
grad_bar), the parameters at
the train-step bars at the applied rates (tests/stable_train_parity.py),
the VAE's EMA the same times (1 - decay) plus 2 ulps. The generator step
leaves the discriminator without a gradient and unchanged, the
discriminator step the VAE unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import discriminators as jd
from ditsep_tpu.models.oobleck import OobleckVAE as JaxVAE
from ditsep_tpu.training import schedules as js
from ditsep_tpu.training.autoencoder import (
    AutoencoderLossConfig as JaxLossConfig,
)
from ditsep_tpu.training.autoencoder import AutoencoderTrainer as JaxAE
from ditsep_tpu_torch.models import discriminators as td
from ditsep_tpu_torch.training import schedules as ts
from ditsep_tpu_torch.training.autoencoder import (
    AutoencoderLossConfig, AutoencoderTrainer,
)
from stable_audio_parity import flat, init_shapes, load_jax, redraw
from stable_train_parity import (
    check_grads, check_params, snapshot, step_bars, torch_tree,
)
from test_torch_autoencoder import (
    LOSS, VAE, _port_vae, _reals, _unflat, _vae_torch, jax_draws, vae_flats,
)

LR = 1e-2
TX = {  # optimizer_configs: group -> (optimizer, scheduler)
    "autoencoder": ({"type": "AdamW", "config": {
        "lr": LR, "betas": [0.8, 0.99], "weight_decay": 1e-3}},
        {"type": "ExponentialLR", "config": {"gamma": 0.9}}),
    "discriminator": ({"type": "AdamW", "config": {
        "lr": 2 * LR, "betas": [0.5, 0.9], "weight_decay": 0.0}},
        {"type": "LinearLR", "config": {"start_factor": 0.5,
                                        "total_iters": 4}}),
}
BANDS = ((0.0, 0.25), (0.25, 1.0))
DISCS = {
    "dac": (lambda: jd.DACDiscriminator(periods=(), fft_sizes=(256,),
                                        bands=BANDS),
            lambda: td.DACDiscriminator(1, periods=(), fft_sizes=(256,),
                                        bands=BANDS)),
    "oobleck": (lambda: jd.OobleckDiscriminator(n_scales=2, capacity=4),
                lambda: td.OobleckDiscriminator(1, n_scales=2, capacity=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(disc, config_tx):
    """(JAX trainer, VAE params, disc params, port trainer, the rate
    functions and Adam settings of the VAE's and the disc's optimizers)."""
    student, _ = vae_flats()
    jdisc, tdisc = DISCS[disc][0](), DISCS[disc][1]()
    dparams = redraw(init_shapes(jdisc, jnp.zeros((1, 1, 512))), 3)
    load_jax(tdisc, dparams)
    kw, tkw = {}, {}
    if config_tx:
        kw = {f"{g[:4]}_tx": js.create_optimizer_from_config(*TX[g])
              for g in ("autoencoder", "discriminator")}
        kw = {"vae_tx": kw["auto_tx"], "disc_tx": kw["disc_tx"]}
        tkw = {"vae_tx": ts.create_optimizer_from_config(
            *TX["autoencoder"]), "disc_tx": ts.create_optimizer_from_config(
            *TX["discriminator"])}
        rates = [ts.create_schedule_from_config(TX[g][1], TX[g][0][
            "config"]["lr"]) for g in ("autoencoder", "discriminator")]
        adam = [dict(b1=0.8, b2=0.99, wd=1e-3), dict(b1=0.5, b2=0.9, wd=0.0)]
    else:
        rates = [ts.inverse_lr_schedule(1.0), ts.inverse_lr_schedule(2.0)]
        adam = [dict(b1=0.8, b2=0.99, wd=1e-3)] * 2
    clip = 0.05 if config_tx else 0.0
    jt = JaxAE(vae=JaxVAE(**VAE), disc=jdisc, loss_cfg=JaxLossConfig(**LOSS),
               lr=1.0, disc_lr=2.0, clip_grad_norm=clip, **kw)
    tt = AutoencoderTrainer(vae=_port_vae(student), disc=tdisc,
                            loss_cfg=AutoencoderLossConfig(**LOSS), lr=1.0,
                            disc_lr=2.0, clip_grad_norm=clip, **tkw)
    adam[0]["clip"] = clip or np.inf
    return (jt, {"params": _unflat(student)}, dparams, tt, rates, adam)


def _grads(loss, module):
    named = dict(module.named_parameters())
    return {k: g.numpy() for k, g in zip(named, torch.autograd.grad(
        loss, list(named.values())))}


def test_gen_and_disc_steps_match_jax():
    """The DAC discriminator (least squares) with the config-built
    optimizers and the VAE's clip."""
    gen_and_disc_steps("dac", True)


def gen_and_disc_steps(disc, config_tx):
    """A gen step then a disc step of both trainers, checked (module
    docstring); tests/test_torch_vaegan_oobleck.py runs the Oobleck
    case."""
    jt, vae_params, dparams, tt, rates, adam = _pair(disc, config_tx)
    floor = 1e-4 if disc == "oobleck" else 0.0
    st = jt.init_state(vae_params, dparams)
    state = tt.init_state()
    vae0, disc0 = snapshot(tt.vae), snapshot(tt.disc)
    reals = _reals(50)
    key = jax.random.PRNGKey(51)
    draws = jax_draws(key)

    def gen_both(st, key, reals):
        g = jax.grad(lambda p: jt.gen_loss(p, st.disc_params, key, reals,
                                           True)[0])(st.vae_params)
        return (g, *jt.gen_step(st, key, reals, warmed_up=True))
    gj, st, mj = jax.jit(gen_both)(st, key, jnp.asarray(reals))
    with torch.enable_grad():
        gt = _grads(tt.gen_loss(torch.from_numpy(reals), True,
                                draws=draws)[0], tt.vae)
    check_grads(gt, _vae_torch(gj), "gen step")
    state, mt = tt.gen_step(state, torch.from_numpy(reals), True,
                            draws=draws)
    assert set(mt) == set(mj)
    for k in mj:
        ref = float(mj[k])
        assert abs(mt[k].item() - ref) <= 1e-4 * abs(ref), k
    if config_tx:  # the clip acts
        norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                           for v in gt.values()))
        assert norm > adam[0]["clip"]
    bars = step_bars([gt], [gt], vae0, [rates[0](0)], **adam[0])
    check_params(snapshot(tt.vae), _vae_torch(st.vae_params), bars, "vae")
    ema_want = _vae_torch(st.ema_vae_params)
    check_params(snapshot(state.ema_vae), ema_want, {
        k: b * (1 - tt.ema_decay) + 2 * np.spacing(np.abs(ema_want[k]))
        for k, b in bars.items()}, "ema")
    assert all(p.grad is None for p in tt.disc.parameters())
    assert all(np.array_equal(v, disc0[k])
               for k, v in snapshot(tt.disc).items())

    key = jax.random.PRNGKey(52)
    draws = jax_draws(key)
    vae1 = snapshot(tt.vae)

    # the gradient on the port's round trip (the two VAEs' parameters
    # differ within the bars, and so their fakes)
    with torch.no_grad():
        dec, r, _, _ = tt._roundtrip(torch.from_numpy(reals), None, draws)

    def disc_both(st, key, reals, r, dec):
        g = jax.grad(lambda dp: jd.discriminator_loss(
            jt.disc, dp, r, dec)[0])(st.disc_params)
        return (g, *jt.disc_step(st, key, reals))
    gj, st, mj = jax.jit(disc_both)(st, key, jnp.asarray(reals),
                                    r.numpy(), dec.numpy())
    with torch.enable_grad():
        gt = _grads(td.discriminator_loss(tt.disc, r, dec)[0], tt.disc)
    check_grads(gt, torch_tree(gj, tt.disc), "disc step", floor)
    state, mt = tt.disc_step(state, torch.from_numpy(reals), draws=draws)
    ref = float(mj["train/discriminator_loss"])
    assert abs(mt["train/discriminator_loss"].item() - ref) <= 1e-4 * abs(ref)
    bars = step_bars([gt], [gt], disc0, [rates[1](0)], **adam[1])
    check_params(snapshot(tt.disc), torch_tree(st.disc_params, tt.disc),
                 bars, "disc")
    assert all(np.array_equal(v, vae1[k]) for k, v in snapshot(
        tt.vae).items())
    assert state.vae_optimizer.count == state.disc_optimizer.count == 1
    assert isinstance(state.vae_optimizer.optimizer, torch.optim.AdamW)


def test_flat_tree_names_of_the_disc_state():
    """The discriminator's tree crosses by its flax names both ways."""
    _, _, dparams, tt, _, _ = _pair("dac", False)
    want = {k[len("params/"):]: v for k, v in flat(dparams).items()}
    from ditsep_tpu_torch.models.weights import params_to_jax
    back = params_to_jax(tt.disc)
    assert set(back) == set(want)
    assert any(k.startswith("mrd_256/band1_conv_4/") for k in back)
