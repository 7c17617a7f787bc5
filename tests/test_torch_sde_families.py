"""The port's OUVE, PriorMix and SBVE SDEs against the JAX package's on the
CPU: mean, std, marginal_prob, drift_diffusion, prior_from_noise,
reverse_drift_diffusion and std_scalar, the std algebra, PriorMix's
sigma_mix, SBVE's sigmas_alphas at t = T, and the float32 time grids.

Tolerances, stated before the runs: the closed forms within 1e-6 of
max|ref|; sigma_mix within 1e-5 of max|ref|, on a signal with a silent
stretch and for odd and even avg_len (see its test for what the 3 s
signal showed); the grids within an ulp of JAX's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.sdes import OUVESDE as JaxOUVE
from ditsep_tpu.sdes import PriorMixSDE as JaxPriorMix
from ditsep_tpu.sdes import SBVESDE as JaxSBVE
from ditsep_tpu.sdes.samplers import _time_grid as jax_time_grid
from ditsep_tpu_torch.sdes import OUVESDE, SBVESDE, PriorMixSDE
from ditsep_tpu_torch.sdes.samplers import _time_grid

MIX_KW = dict(d_lambda=2.0, sigma_min=0.05, sigma_max=0.5, N=30)
FAMILIES = {
    "ouve": (JaxOUVE, OUVESDE, dict(theta=1.5, sigma_min=0.05,
                                    sigma_max=0.5, N=30)),
    "sbve": (JaxSBVE, SBVESDE, dict(k=2.6, c=0.4, eps=1e-8, N=30)),
    "priormix": (JaxPriorMix, PriorMixSDE, dict(avg_len=32, **MIX_KW)),
}
T_VALUES = np.array([0.03, 0.4, 0.77, 1.0], np.float32)


def _close(got, want, rel=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _std_parts(std):
    """The arrays of a std: itself, or a MixStd / PriorMixStd's fields."""
    return tuple(std) if isinstance(std, tuple) else (std,)


def _inputs(seed=0, b=4, t_len=120):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, t_len)).astype(np.float32)
    mix = (0.3 * rng.standard_normal((b, 1, t_len))).astype(np.float32)
    mix[:, :, 40:80] = 0.0  # a silent stretch: sigma_mix at its clamp
    return x, mix


def _score_fns():
    w = np.array([0.8, -0.6], np.float32).reshape(1, 2, 1)
    return (lambda x, t, y: -x * jnp.asarray(w) + 0.3 * y * t[:, None, None],
            lambda x, t, y: (-x * torch.from_numpy(w)
                             + 0.3 * y * t[:, None, None]))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_closed_forms_match_jax(family):
    jcls, tcls, kw = FAMILIES[family]
    js, ts = jcls(**kw), tcls(**kw)
    x, mix = _inputs()
    jx, jm, jt = jnp.asarray(x), jnp.asarray(mix), jnp.asarray(T_VALUES)
    tx, tm, tt = (torch.from_numpy(a) for a in (x, mix, T_VALUES))
    # the std (and its algebra), in each SDE's own signature
    if family == "priormix":
        jstd, tstd = js.std(jt, jm, 3), ts.std(tt, tm, 3)
        for a, b in zip(ts.cov_eigval(tt), js.cov_eigval(jt)):
            _close(a, b)
        _close(ts.mean(tx, tt), js.mean(jx, jt))
    else:
        jstd, tstd = js.std(jt), ts.std(tt)
        _close(ts.mean(tx, tt, tm), js.mean(jx, jt, jm))
    for a, b in zip(_std_parts(tstd), _std_parts(jstd)):
        _close(a, b)
    _close(ts.std_scalar(tstd), js.std_scalar(jstd))
    _close(ts.mult_std(tstd, tx), js.mult_std(jstd, jx))
    _close(ts.mult_std_inv(tstd, tx), js.mult_std_inv(jstd, jx))
    (tmean, tstd2), (jmean, jstd2) = (ts.marginal_prob(tx, tt, tm),
                                      js.marginal_prob(jx, jt, jm))
    _close(tmean, jmean)
    for a, b in zip(_std_parts(tstd2), _std_parts(jstd2)):
        _close(a, b)
    for a, b in zip(ts.drift_diffusion(tx, tt, tm),
                    js.drift_diffusion(jx, jt, jm)):
        _close(a, b)
    if family != "sbve":  # SBVE has no variance of its own
        _close(ts.var(tt), js.var(jt))
    jscore, tscore = _score_fns()
    for pf in (False, True):
        for a, b in zip(ts.reverse_drift_diffusion(tscore, tx, tt, tm, pf),
                        js.reverse_drift_diffusion(jscore, jx, jt, jm, pf)):
            _close(a, b)
        for a, b in zip(ts.reverse_discretize(tscore, tx, tt, tm, dt=0.05,
                                              probability_flow=pf),
                        js.reverse_discretize(jscore, jx, jt, jm, dt=0.05,
                                              probability_flow=pf)):
            _close(a, b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mix_channels", [1, 2])
def test_prior_from_noise_matches_jax(family, mix_channels):
    """A (B, 1, T) mix and a mix that already has the state's 2 channels
    (PriorMix then takes the mix itself as the mean, the reference's
    quirk)."""
    jcls, tcls, kw = FAMILIES[family]
    js, ts = jcls(**kw), tcls(**kw)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, 2, 90)).astype(np.float32)
    mix = (0.2 * rng.standard_normal((3, mix_channels, 90))).astype(
        np.float32)
    if family == "sbve":  # the bridge's prior is y, no draw
        want = js.prior_sampling(jax.random.PRNGKey(0), z.shape,
                                 jnp.asarray(mix))
    else:
        want = js.prior_from_noise(jnp.asarray(z), z.shape, jnp.asarray(mix))
    got = ts.prior_from_noise(torch.from_numpy(z), z.shape,
                              torch.from_numpy(mix))
    _close(got, want)


def _sigma_mix_f64(mix, k):
    """sigma_mix's semantics in float64 (a running sum loses nothing
    there): the mean of mix^2 over a window of k with k // 2 zeros on each
    side counted, the extra last frame of an even k dropped."""
    p2 = np.pad(mix.astype(np.float64) ** 2,
                [(0, 0)] * (mix.ndim - 1) + [(k // 2, k // 2)])
    cs = np.concatenate([np.zeros(p2.shape[:-1] + (1,)), np.cumsum(p2, -1)],
                        -1)
    win = ((cs[..., k:] - cs[..., :-k]) / k)[..., :mix.shape[-1]]
    return 0.5 * np.sqrt(np.maximum(win, 1e-4))


@pytest.mark.parametrize("avg_len", [510, 509, 64])
@pytest.mark.parametrize("seconds", [0.25, 3.0])
def test_sigma_mix_matches_jax(avg_len, seconds):
    """At 16 kHz with a silent stretch and a quiet one near the clamp,
    avg_len even (510, 64) and odd. The port is held to the float64
    semantics within 1e-6 of max|ref|. Against JAX: within 1e-5 of
    max|ref| on the 0.25 s signal; on the 3 s one (the enhancement crop)
    JAX's windowed means, differences of a float32 running sum, lose up to
    3.2e-5 (avg_len 510) and 1.7e-4 (avg_len 64) of max|ref| to
    cancellation, so there every difference from JAX must lie within JAX's
    own error against float64 plus 1e-6 of max|ref|."""
    rng = np.random.default_rng(2)
    n = int(seconds * 16000)
    mix = (0.1 * rng.standard_normal((2, 1, n))).astype(np.float32)
    mix[:, :, n // 3:2 * n // 3] = 0.0
    mix[:, :, 2 * n // 3:2 * n // 3 + n // 12] *= 0.1
    js, ts = (cls(avg_len=avg_len, **MIX_KW)
              for cls in (JaxPriorMix, PriorMixSDE))
    want = np.asarray(js.sigma_mix(jnp.asarray(mix)))
    exact = _sigma_mix_f64(mix, avg_len)
    got = ts.sigma_mix(torch.from_numpy(mix))
    assert got.shape == mix.shape
    _close(got, exact, 1e-6)
    if seconds < 1:
        _close(got, want, 1e-5)
    else:
        top = np.abs(exact).max()
        assert (np.abs(got.numpy() - want)
                <= np.abs(want - exact) + 1e-6 * top).all()
    # the silent stretch sits at the clamp exactly, away from its edges
    inner = got[..., n // 3 + avg_len:2 * n // 3 - avg_len]
    assert torch.equal(inner, torch.full_like(inner, 0.5 * math.sqrt(
        np.float32(1e-4))))


def test_sbve_sigmas_alphas_at_T():
    js, ts = JaxSBVE(**FAMILIES["sbve"][2]), SBVESDE(**FAMILIES["sbve"][2])
    t = np.array([1.0, 0.999, 0.5, 1e-4], np.float32)
    for a, b in zip(ts.sigmas_alphas(torch.from_numpy(t)),
                    js.sigmas_alphas(jnp.asarray(t))):
        _close(a, b)
    sigma_t, sigma_T, sigma_bart, *_ = ts.sigmas_alphas(
        torch.ones(3, dtype=torch.float32))
    assert torch.equal(sigma_t, sigma_T)  # the same expression at T
    assert torch.equal(sigma_bart, torch.sqrt(torch.full((3,), 1e-8)))
    assert torch.isfinite(ts.std(torch.ones(3))).all()


@pytest.mark.parametrize("schedule", [None, "linear", "log", "revlog"])
@pytest.mark.parametrize("n", [4, 31, 51])
@pytest.mark.parametrize("eps", [3e-2, 1e-4])
def test_time_grids_within_an_ulp_of_jax(schedule, n, eps):
    """Both build the grid in float32 by JAX's formula, start (1 - i/div)
    + stop i/div, but XLA rewrites it (and folds it into constants under
    jit, so its last bits depend on the jit context): a uniform grid
    agrees within one ulp of T absolute, a logarithmic one, 10 to the
    power of such a grid, within 2e-6 relative."""
    want = np.asarray(jax_time_grid(schedule, 1.0, eps, n))
    got = _time_grid(schedule, 1.0, eps, n)
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want)
    if schedule in (None, "linear"):
        assert (err <= np.spacing(np.float32(1.0))).all(), err.max()
        assert got[0] == want[0] and got[-1] == want[-1]
    else:
        assert (err <= 2e-6 * want).all(), (err / want).max()
