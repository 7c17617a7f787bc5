"""The decoder finetune's gen step then disc step over two gloo ranks
against the JAX package's ``LDMTrainer.gen_step`` / ``disc_step`` on the
same global batch of 4, on tests/test_torch_ldm.py's tiny pair: each rank
decodes its 2 rows, and the PIT minimum of the MRSTFT takes the
permutation of least global loss.

Tolerances, stated before the runs (tests/test_torch_ldm.py's): the
losses 1e-4 relative; each step's all-reduced gradient leaf by leaf
within 1e-3 of JAX's leaf max; the parameters within 1e-3 * rate where
the gradient is significant and 2 * rate elsewhere, plus twice the
difference float64 clip + AdamW makes of the two gradients; the decoder's
EMA within those bars times (1 - decay) plus 2 float32 ulps.
"""
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models.discriminators import (
    discriminator_loss as jax_disc_loss,
)
from ditsep_tpu_torch.training.schedules import inverse_lr_schedule
from test_torch_ldm import (
    LR, TL, D, T, _check_params, _decoder_torch, _disc_torch, _pair,
    check_grads, step_bars,
)
from test_torch_parallel import B, run_ranks
from test_torch_parallel_gan import gan_cases_worker

GEN_METRICS = ("train/loss", "train/pit_mrstft_loss", "train/loss_adv",
               "train/feature_matching_loss", "train/decoded_std")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _prefixed(d):
    return {f"decoder.{k}": v for k, v in d.items()}


@pytest.fixture(scope="module")
def ldm_steps(tmp_path_factory):
    """The two ranks' steps (run while JAX takes its own) and JAX's: the
    states after each step, its metrics and its gradient."""
    jldm, vae_params, jparams, tldm = _pair(
        fresh=True, weights=dict(fft_sizes=(256, 64), hop_sizes=(64, 16)))
    rng = np.random.default_rng(90)
    lat = rng.standard_normal((B, 2, D, TL)).astype(np.float32)
    reals = (0.3 * rng.standard_normal((B, 2, T))).astype(np.float32)
    snap = lambda m: {k: v.detach().numpy().copy()  # noqa: E731
                      for k, v in m.state_dict().items()}
    p0 = {"gen": _prefixed(snap(tldm.latent_trainer.vae.decoder)),
          "disc": snap(tldm.disc)}
    out = tmp_path_factory.mktemp("jax_ldm") / "two.pt"
    jax_res = {}
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, gan_cases_worker, str(out),
                          pickle.dumps({"ldm": (tldm, lat, reals)}))
        frozen, _ = jldm.split_vae_params(vae_params)
        st = jldm.init_state(vae_params, jparams)
        lj, rj = jnp.asarray(lat), jnp.asarray(reals)
        g = jax.jit(jax.grad(lambda dp, gp: jldm.gen_loss(
            dp, gp, frozen, lj, rj, True)[0]))(st.decoder_params,
                                               st.disc_params)
        st, m = jax.jit(jldm.gen_step, static_argnames=("warmed_up",))(
            st, frozen, lj, rj, warmed_up=True)
        jax_res["gen"] = (_decoder_torch(g), m,
                          _decoder_torch(st.decoder_params),
                          _decoder_torch(st.ema_decoder_params))
        g = jax.jit(jax.grad(lambda gp, dp: jax_disc_loss(
            jldm.disc, gp, rj, jldm.decode_with(frozen, dp, lj, T))[0]))(
                st.disc_params, st.decoder_params)
        st, m = jax.jit(jldm.disc_step)(st, frozen, lj, rj)
        jax_res["disc"] = (_disc_torch(g), m, _disc_torch(st.disc_params),
                           None)
        ranks.result()
    assert int(st.step) == 2
    return torch.load(out, weights_only=False)["ldm"], jax_res, p0, tldm


@pytest.mark.parametrize("step", ["gen", "disc"])
def test_ldm_step_over_two_ranks_matches_jax(ldm_steps, step):
    two, jax_res, p0, tldm = ldm_steps
    grads_j, mj, params_j, ema_j = jax_res[step]
    got = two[step]
    wrap = _prefixed if step == "gen" else dict
    grads = wrap(got["grads"])
    check_grads(grads, grads_j, f"{step} step")
    for k in (GEN_METRICS if step == "gen"
              else ("train/discriminator_loss",)):
        ref = float(mj[k])
        assert abs(got["metrics"][k] - ref) <= 1e-4 * abs(ref), k
    rate = inverse_lr_schedule(LR if step == "gen" else 2 * LR)(0)
    bars = step_bars([grads], [grads_j], p0[step], [rate], 1.0)
    _check_params(wrap(got["state"]), params_j, bars, step)
    if step == "gen":
        d = tldm.ema_decay
        _check_params(wrap(got["ema"]), ema_j, {
            k: b * (1 - d) + 2 * np.spacing(np.abs(ema_j[k]))
            for k, b in bars.items()}, "ema")
