"""The VAE-GAN's gen step then disc step over two gloo ranks against the
JAX package's ``AutoencoderTrainer.gen_step`` / ``disc_step`` on the same
global batch of 4 with JAX's own draws (tests/test_torch_autoencoder.py:
jax_draws: the posterior's, the latent mask's and the teacher's), on that
file's pair with the latent mask, the teacher and the encoder frozen on
warmup: each rank takes its rows of every draw.

Tolerances (tests/test_torch_ldm.py's step bars): every metric 1e-4
relative; each step's all-reduced gradient leaf by leaf within 1e-3 of
JAX's leaf max; the parameters within 1e-3 * rate where the gradient is
significant and 2 * rate elsewhere, plus twice the difference float64
clip + AdamW makes of the two gradients; the VAE's EMA within those bars
times (1 - decay) plus 2 float32 ulps. The first run left the explained
part out, as tests/test_torch_autoencoder.py's one-process step does, and
one element of a discriminator's weight-norm gain moved 2.7e-6 from
JAX's against a bar of 2e-6: where Adam's eps is not small beside the
gradient, the two ranks' reduction order moves the update past it.
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
from test_torch_autoencoder import LR, T, _pair, _vae_torch, jax_draws
from test_torch_ldm import _check_params, _disc_torch, check_grads, step_bars
from test_torch_parallel import B, run_ranks
from test_torch_parallel_gan import gan_cases_worker


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vaegan_steps(tmp_path_factory):
    """The two ranks' steps (run while JAX takes its own) and JAX's: the
    states after each step, its metrics and its gradient."""
    jt, vae_params, jparams, tt = _pair(
        teacher=True, latent_mask_ratio=0.3, encoder_freeze_on_warmup=True)
    reals = (0.3 * np.random.default_rng(100).standard_normal((B, 1, T))
             ).astype(np.float32)
    keys = jax.random.PRNGKey(101), jax.random.PRNGKey(102)
    draws = [jax_draws(k, b=B) for k in keys]
    snap = lambda m: {k: v.detach().numpy().copy()  # noqa: E731
                      for k, v in m.state_dict().items()}
    p0 = {"gen": snap(tt.vae), "disc": snap(tt.disc)}
    out = tmp_path_factory.mktemp("jax_vaegan") / "two.pt"
    jax_res = {}
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, gan_cases_worker, str(out),
                          pickle.dumps({"vaegan": (tt, reals, *draws)}))
        st = jt.init_state(vae_params, jparams)
        r = jnp.asarray(reals)
        g = jax.jit(jax.grad(lambda vp, dp: jt.gen_loss(
            vp, dp, keys[0], r, True)[0]))(st.vae_params, st.disc_params)
        st, m = jax.jit(jt.gen_step, static_argnames=("warmed_up",))(
            st, keys[0], r, warmed_up=True)
        jax_res["gen"] = (_vae_torch(g), m, _vae_torch(st.vae_params),
                          _vae_torch(st.ema_vae_params))

        def disc_loss(dp, vp):
            dec, reals_t, _, _ = jt._roundtrip(vp, keys[1], r)
            return jax_disc_loss(jt.disc, dp, jax.lax.stop_gradient(
                reals_t), jax.lax.stop_gradient(dec))[0]

        g = jax.jit(jax.grad(disc_loss))(st.disc_params, st.vae_params)
        st, m = jax.jit(jt.disc_step)(st, keys[1], r)
        jax_res["disc"] = (_disc_torch(g), m, _disc_torch(st.disc_params),
                           None)
        ranks.result()
    assert int(st.step) == 2
    return torch.load(out, weights_only=False)["vaegan"], jax_res, p0, tt


@pytest.mark.parametrize("step", ["gen", "disc"])
def test_vaegan_step_over_two_ranks_matches_jax(vaegan_steps, step):
    two, jax_res, p0, tt = vaegan_steps
    grads_j, mj, params_j, ema_j = jax_res[step]
    got = two[step]
    check_grads(got["grads"], grads_j, f"{step} step")
    assert set(mj) <= set(got["metrics"])
    for k in mj:
        ref = float(mj[k])
        assert abs(got["metrics"][k] - ref) <= 1e-4 * abs(ref), k
    rate = inverse_lr_schedule(LR if step == "gen" else 2 * LR)(0)
    bars = step_bars([got["grads"]], [grads_j], p0[step], [rate], np.inf)
    _check_params(got["state"], params_j, bars, step)
    if step == "gen":
        d = tt.ema_decay
        _check_params(got["ema"], ema_j, {
            k: b * (1 - d) + 2 * np.spacing(np.abs(ema_j[k]))
            for k, b in bars.items()}, "ema")
