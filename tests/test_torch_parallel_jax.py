"""One train step of the waveform trainer over two gloo ranks against the
JAX package's ``train_step`` on the same global batch of 4 with JAX's own
draws (tests/test_torch_train.py:jax_draws): each rank takes its 2 rows
and its rows of the draws, so a draw or a reduction routed wrongly over
the ranks shows here even where the one-process step shares the fault.

Tolerances, stated before the runs (PR 5's bars, tests/test_torch_train_
step.py): the loss and the grad norm 1e-4 relative; the all-reduced
gradient leaf by leaf within 1e-3 of JAX's leaf max (the attention's key
bias, whose exact gradient is 0, within 1e-6 of the largest leaf's max on
both sides, as tests/test_torch_train.py:test_gradients_match_jax_grad);
the parameters within 1e-3 * lr where the gradient is at least 1e-3 of
its leaf's max and 2 * lr elsewhere; the EMA within those bars times
(1 - decay) plus 2 float32 ulps.
"""
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.configs import build_diffsep_trainer as jax_build
from ditsep_tpu.configs import diffsep as jax_diffsep
from ditsep_tpu.configs import override as jax_override
from ditsep_tpu.utils import separate as jax_sep
from ditsep_tpu_torch.configs import build_diffsep_trainer, diffsep, override
from ditsep_tpu_torch.models.weights import params_from_jax, params_to_jax
from test_torch_latent import _unflat
from test_torch_parallel import B, cases_worker, run_ranks
from test_torch_train import TINY, _batch, flat_torch_layout, jax_draws
from test_torch_train_step import _check_state, _leaf_bars

LENGTH = 800


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def check_grads_vs_jax(got, want):
    """``got`` (the port's, by parameter name) against JAX's gradient in
    the port's layout, at the bars above."""
    want = dict(want)
    assert not want.pop("backbone.all_modules.0.W").any()  # stop_gradient
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        if k.endswith("NIN_1.b"):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-6 * top
        else:
            err = float(np.abs(got[k] - w).max())
            assert err <= 1e-3 * np.abs(w).max(), (k, err)


def check_step_vs_jax(two, mj, st, tt, grads):
    """The step's metrics, parameters and EMA against JAX's state ``st``
    after one step; ``grads`` set which elements are significant."""
    for k in ("train/score_loss", "train/grad_norm"):
        ref = float(mj[k])
        assert abs(two["metrics"][k] - ref) <= 1e-4 * abs(ref), k
    tensors = lambda d: {k: torch.from_numpy(v)  # noqa: E731
                         for k, v in d.items()}
    _check_state(tt, tensors(two["state"]), tensors(two["ema"]), st.params,
                 st.ema_params, _leaf_bars([grads], tt.cfg.lr, 1),
                 tt.cfg.ema_decay)


def seeded_ncsnpp_pair():
    """tests/test_torch_train.py's tiny pair (JAX trainer, params, port
    trainer) without JAX's init (its trace takes seconds): the port's
    seeded weights perturbed so that every layer carries gradient,
    carried to JAX by the weight bridge."""
    jt = jax_build(jax_override(jax_diffsep(), TINY))
    tt = build_diffsep_trainer(override(diffsep(), TINY), device="cpu",
                               seed=0)
    rng = np.random.default_rng(2)
    flat = {k: (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params_to_jax(tt.model).items()}
    tt.model.load_state_dict(params_from_jax(flat), strict=True)
    return jt, {"params": _unflat(flat)}, tt


@pytest.fixture(scope="module")
def waveform_step(tmp_path_factory):
    """The two ranks' step (run while JAX takes its own) and JAX's."""
    jt, params, tt = seeded_ncsnpp_pair()
    rng = np.random.default_rng(70)
    mix, tgt = _batch(b=B, t_len=LENGTH, seed=71)
    mix = mix + 0.01 * rng.standard_normal(mix.shape).astype(np.float32)
    key = jax.random.PRNGKey(72)
    draws = jax_draws(tt.cfg, key, *tgt.shape)
    out = tmp_path_factory.mktemp("jax_step") / "two.pt"
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, cases_worker, str(out), pickle.dumps(
            {"diffsep": (tt, (mix, tgt), draws)}))
        (m, t), _, _ = jax_sep.normalize_batch((jnp.asarray(mix),
                                                jnp.asarray(tgt)))
        grads_j = jax.jit(jax.grad(lambda p: jt.training_loss(
            p, key, m, t, train=True)))(params)
        st, mj = jax.jit(jt.train_step)(jt.init_state(params), key, (
            jnp.asarray(mix), jnp.asarray(tgt)))
        ranks.result()
    two = torch.load(out, weights_only=False)["diffsep"]
    return two, flat_torch_layout(grads_j), st, mj, tt


def test_gradient_over_two_ranks_matches_jax(waveform_step):
    two, grads_j, _, _, _ = waveform_step
    check_grads_vs_jax(two["grads"], grads_j)


def test_train_step_over_two_ranks_matches_jax(waveform_step):
    two, _, st, mj, tt = waveform_step
    assert int(st.step) == 1
    check_step_vs_jax(two, mj, st, tt, two["grads"])
