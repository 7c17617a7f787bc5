"""``DiffSepTrainer.separate`` of each new family and sampler, and
``ode_sample`` rk4, through an nf=16 NCSN++ with the same weights in the
port and the JAX package, on the CPU: diffsep_ouve (PC with ald),
enhancement (PriorMix, PC with ald2), diffsep with ab2, and diffsep_sb
(the bridge's 'ode' and 'sde' under EDM preconditioning). JAX's draws are
rebuilt from its key splits (tests/test_torch_samplers.py); the tiny
NCSN++ (64 bins x 64 frames at 800 samples) and its weights are
tests/test_torch_train_families.py's.

Tolerances, stated before the runs: 1e-3 of max|ref| (the bar of the
separation path, tests/test_torch_separate.py); the NFE equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu import sdes as jsdes
from ditsep_tpu_torch import sdes as tsdes
from test_torch_samplers import B, _close, _normal, ab2_draws
from test_torch_train_families import tiny_family_pair


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LENGTH = 800


def _mix(seed=9):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((B, 1, LENGTH))).astype(np.float32)


@pytest.mark.parametrize("family,sampler,sampler_type,n", [
    ("diffsep_ouve", "pc", None, 3),
    ("enhancement", "pc", None, 3),
    ("diffsep", "ab2", None, 3),
    ("diffsep_sb", "pc", "ode", 1),
    ("diffsep_sb", "pc", "sde", 3),
])
def test_separate_matches_jax_through_score_model(family, sampler,
                                                  sampler_type, n):
    """The bridge's 'ode' branch at N = 1: past its first step it scales
    the convs' float32 round-off by thousands (test_sb_sample_matches_jax
    holds its recursion to a float64 run), at the first alone by 63."""
    jt, params, tt = tiny_family_pair(family, LENGTH)
    if sampler_type is not None:
        for t in (jt, tt):
            object.__setattr__(t, "sde", type(t.sde)(
                **{**t.sde.__dict__, "sampler_type": sampler_type}))
    mix = _mix()
    key = jax.random.PRNGKey(10)
    want, jnfe = jax.jit(lambda p, k, m: jt.separate(
        p, k, m, N=n, sampler=sampler))(params, key, jnp.asarray(mix))
    jnfe = int(jnfe)
    shape = (B, 2, LENGTH)
    if family == "diffsep_sb":
        noise = np.stack([_normal(k, shape) for k in jax.random.split(key, n)])
    elif sampler == "ab2":
        noise = ab2_draws(key, n, shape, stochastic=False)
    else:  # pc_sample: the prior, each step's corrector and predictor
        key, k_prior = jax.random.split(key)
        keys = jax.random.split(key, 2 * n).reshape(n, 2, -1)
        noise = (_normal(k_prior, shape),
                 np.stack([[_normal(jax.random.split(k[0])[0], shape)]
                           for k in keys]),
                 np.stack([_normal(k[1], shape) for k in keys]))
    got, tnfe = tt.separate(torch.from_numpy(mix), N=n, sampler=sampler,
                            noise=noise)
    assert tnfe == jnfe
    assert got.shape == shape and bool(torch.isfinite(got).all())
    _close(got, want, 1e-3)


def test_ode_sample_rk4_matches_jax_through_score_model():
    jt, params, tt = tiny_family_pair("diffsep_ouve", LENGTH)
    mix = _mix(11)
    key = jax.random.PRNGKey(12)
    want, jnfe = jax.jit(lambda p, k, m: jsdes.ode_sample(
        jt.sde, lambda x, t, y: jt.model_fwd(p, x, t, y), k, m, N=1,
        method="rk4"))(params, key, jnp.asarray(mix))
    jnfe = int(jnfe)
    prior = _normal(jax.random.split(key)[1], (B, 2, LENGTH))
    with torch.no_grad():
        got, tnfe = tsdes.ode_sample(tt.sde, tt.model_fwd,
                                     torch.from_numpy(mix), N=1,
                                     method="rk4", noise=prior)
    assert tnfe == jnfe == 5
    _close(got, want, 1e-3)
