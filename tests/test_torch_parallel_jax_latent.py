"""One ``train_step_latent`` over two gloo ranks against the JAX package's
on the same global batch of 4 with JAX's own draws (the VAE posterior's
and the loss's, tests/test_torch_latent.py:latent_loss_draws), on
tests/test_torch_latent.py's tiny configuration: each rank encodes its 2
rows with its rows of the posterior draws. The weights are the port's,
seeded and carried to JAX by the weight bridge (JAX's init traces for
tens of seconds); JAX's gradient is not taken here (its trace costs as
much again): tests/test_torch_latent_train.py holds the one-process
gradient to JAX's, tests/test_torch_parallel.py the two ranks' to the
one-process one.

Tolerances, stated before the runs (PR 5's bars, tests/test_torch_train_
step.py): the loss and the grad norm 1e-4 relative; the parameters within
1e-3 * lr where the gradient is at least 1e-3 of its leaf's max and
2 * lr elsewhere; the EMA within those bars times (1 - decay) plus 2
float32 ulps.
"""
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu import configs as jax_configs
from ditsep_tpu_torch import configs as tconfigs
from ditsep_tpu_torch.models.weights import (
    oobleck_params_from_jax, params_from_jax, params_to_jax,
)
from test_torch_latent import LENGTH, TINY, _unflat, latent_loss_draws
from test_torch_ldm import seeded_vae_flat
from test_torch_parallel import B, cases_worker, run_ranks
from test_torch_parallel_jax import check_step_vs_jax


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_latent_pair():
    """(JAX trainer, score params, VAE params, port trainer) on the tiny
    configuration, the port's seeded weights perturbed so that every leaf
    counts (the snake's zero-init too)."""
    jt = jax_configs.build_latent_trainer(jax_configs.override(
        jax_configs.latent_diffsep_ouve(), TINY))
    tt = tconfigs.build_latent_trainer(tconfigs.override(
        tconfigs.latent_diffsep_ouve(), TINY), device="cpu", seed=0)
    vflat = seeded_vae_flat(tt.vae, seed=1)
    tt.vae.load_state_dict(oobleck_params_from_jax(vflat), strict=True)
    rng = np.random.default_rng(2)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params_to_jax(tt.model).items()}
    tt.model.load_state_dict(params_from_jax(flat), strict=True)
    return jt, {"params": _unflat(flat)}, {"params": _unflat(vflat)}, tt


@pytest.fixture(scope="module")
def latent_step(tmp_path_factory):
    """The two ranks' step (run while JAX takes its own) and JAX's."""
    jt, params, vae_params, tt = seeded_latent_pair()
    rng = np.random.default_rng(80)
    tgt = (0.3 * rng.standard_normal((B, 2, LENGTH))).astype(np.float32)
    tgt[:, 1] *= 0.5
    mix = tgt.sum(1, keepdims=True)
    key = jax.random.PRNGKey(81)
    draws = latent_loss_draws(tt.cfg, key, b=B)
    out = tmp_path_factory.mktemp("jax_latent") / "two.pt"
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, cases_worker, str(out), pickle.dumps(
            {"latent": (tt, (mix, tgt), draws)}))
        m, t = jnp.asarray(mix), jnp.asarray(tgt)
        st, mj = jax.jit(jt.train_step_latent)(jt.init_state(params),
                                               vae_params, key, (m, t))
        ranks.result()
    return torch.load(out, weights_only=False)["latent"], st, mj, tt


def test_latent_train_step_over_two_ranks_matches_jax(latent_step):
    two, st, mj, tt = latent_step
    assert int(st.step) == 1
    check_step_vs_jax(two, mj, st, tt, two["grads"])
