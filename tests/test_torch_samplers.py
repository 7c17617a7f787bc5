"""The port's predictors, correctors and samplers against the JAX package's
on the CPU: euler_maruyama, reverse_diffusion (with a dt), langevin, ald and
ald2 as single steps; pc_sample on every schedule, with and without the
schedule's dt, with its trajectory; ab2_sample (deterministic and
stochastic), ode_sample (euler, heun, rk4), ode_sample_scipy and sb_sample
('ode', 'sde'). Where the JAX sampler draws from a key and takes no noise,
its draws are rebuilt from the same key splits (ditsep_tpu/sdes/
samplers.py:335,342 for ab2_sample, :410 for the ODE samplers, :541 for
sb_sample) and handed to the port as ``noise``. The samplers through a
score model are tests/test_torch_samplers_model.py's.

Tolerances, stated before the runs: with a linear score function 1e-5 of
max|ref|; the NFE equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu import sdes as jsdes
from ditsep_tpu.sdes import correctors as jcorr
from ditsep_tpu.sdes import predictors as jpred
from ditsep_tpu_torch import sdes as tsdes
from ditsep_tpu_torch.sdes import correctors as tcorr
from ditsep_tpu_torch.sdes import predictors as tpred

SDES = {
    "mix": ("MixSDE", dict(d_lambda=2.0, sigma_min=0.05, sigma_max=0.5,
                           N=30)),
    "priormix": ("PriorMixSDE", dict(avg_len=16, d_lambda=2.0,
                                     sigma_min=0.05, sigma_max=0.5, N=30)),
    "ouve": ("OUVESDE", dict(theta=1.5, sigma_min=0.05, sigma_max=0.5,
                             N=30)),
    "sbve": ("SBVESDE", dict(k=2.6, c=0.4, eps=1e-8, N=5)),
}
B, T_LEN = 2, 96


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel workers, and PyTorch's default of one thread a core in each
    of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _pair(name, **kw):
    cls, base = SDES[name]
    kw = {**base, **kw}
    return getattr(jsdes, cls)(**kw), getattr(tsdes, cls)(**kw)


def _score_fns():
    """A linear score: -W x + 0.3 t y, W differing per source."""
    w = np.array([0.9, -0.5], np.float32).reshape(1, 2, 1)
    return (lambda x, t, y: -x * jnp.asarray(w) + 0.3 * y * t[:, None, None],
            lambda x, t, y: (-x * torch.from_numpy(w)
                             + 0.3 * y * t[:, None, None]))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    y = (0.5 * rng.standard_normal((B, 1, T_LEN))).astype(np.float32)
    x = rng.standard_normal((B, 2, T_LEN)).astype(np.float32)
    z = rng.standard_normal((B, 2, T_LEN)).astype(np.float32)
    return x, y, z


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float32))


# ------------------------------------------------------ single steps ---
STEPS = {
    "euler_maruyama": ("predictor", {}),
    "euler_maruyama_dt": ("predictor", {"dt": 0.07}),
    "reverse_diffusion_dt": ("predictor", {"dt": 0.07}),
    "langevin": ("corrector", {}),
    "ald": ("corrector", {}),
    "ald2": ("corrector", {}),
}


@pytest.mark.parametrize("sde,step", [
    (sde, step) for sde in ("mix", "priormix", "ouve")
    for step in sorted(STEPS)
    if not (step == "ald2" and sde == "ouve")])  # ald2: matrix SDEs only
def test_single_steps_match_jax(sde, step):
    kind, kw = STEPS[step]
    name = step.removesuffix("_dt")
    js, ts = _pair(sde)
    jscore, tscore = _score_fns()
    x, y, z = _data(1)
    t = np.array([0.8, 0.3], np.float32)
    jargs = (js, jscore, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
             jax.random.PRNGKey(0))
    targs = (ts, tscore, torch.from_numpy(x), torch.from_numpy(t),
             torch.from_numpy(y))
    if kind == "predictor":
        jout = getattr(jpred, f"{name}_predictor")(
            *jargs, noise=jnp.asarray(z), **kw)
        tout = getattr(tpred, f"{name}_predictor")(
            *targs, noise=torch.from_numpy(z), **kw)
    else:
        zz = np.stack([z, z[:, ::-1]])  # two corrector steps
        jout = getattr(jcorr, f"{name}_corrector")(
            *jargs, snr=0.4, n_steps=2, noises=jnp.asarray(zz))
        tout = getattr(tcorr, f"{name}_corrector")(
            *targs, snr=0.4, n_steps=2, noises=torch.from_numpy(zz))
    for a, b in zip(tout, jout):
        _close(a, b)


# ------------------------------------------------------- pc_sample ---
PC_CASES = {
    "plain_em_langevin": dict(predictor="euler_maruyama",
                              corrector="langevin"),
    "linear": dict(schedule="linear"),
    "linear_dt": dict(schedule="linear", use_schedule_dt=True),
    "log_dt": dict(schedule="log", use_schedule_dt=True,
                   predictor="euler_maruyama"),
    "revlog": dict(schedule="revlog", corrector="ald"),
    "none_corrector": dict(corrector="none", schedule="log"),
}


@pytest.mark.parametrize("sde", ["priormix", "ouve"])
@pytest.mark.parametrize("case", sorted(PC_CASES))
def test_pc_sample_matches_jax(sde, case):
    kw = dict(PC_CASES[case])
    if sde == "ouve" and kw.get("corrector", "ald2") == "ald2":
        kw["corrector"] = "ald"
    js, ts = _pair(sde)
    jscore, tscore = _score_fns()
    _, y, _ = _data(2)
    n, steps = 4, 2 if kw.get("corrector") != "none" else 0
    rng = np.random.default_rng(3)
    noise = (rng.standard_normal((B, 2, T_LEN)).astype(np.float32),
             rng.standard_normal((n, steps, B, 2, T_LEN)).astype(np.float32),
             rng.standard_normal((n, B, 2, T_LEN)).astype(np.float32))
    common = dict(N=n, snr=0.3, corrector_steps=steps, intermediate=True,
                  **kw)
    jx, jnfe, (jxs, jmeans) = jsdes.pc_sample(
        js, jscore, jax.random.PRNGKey(0), jnp.asarray(y), noise=noise,
        **common)
    tx, tnfe, (txs, tmeans) = tsdes.pc_sample(
        ts, tscore, torch.from_numpy(y), noise=noise, **common)
    assert tnfe == jnfe
    _close(tx, jx)
    _close(txs, jxs)
    _close(tmeans, jmeans)


# ----------------------------------------------- ab2 and ODE samplers ---
def ab2_draws(key, n, shape, stochastic):
    """ab2_sample's draws: the prior from the first split's second key,
    then one a step from split(key, N - 1)."""
    key, k_prior = jax.random.split(key)
    step_keys = jax.random.split(key, max(n - 1, 1))
    steps = (np.stack([_normal(k, shape) for k in step_keys])
             if stochastic else None)
    return _normal(k_prior, shape), steps


@pytest.mark.parametrize("sde", ["mix", "priormix", "ouve"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_ab2_sample_matches_jax(sde, stochastic):
    js, ts = _pair(sde)
    jscore, tscore = _score_fns()
    _, y, _ = _data(4)
    key, n = jax.random.PRNGKey(5), 6
    want, jnfe = jsdes.ab2_sample(js, jscore, key, jnp.asarray(y), N=n,
                                  stochastic=stochastic)
    noise = ab2_draws(key, n, (B, 2, T_LEN), stochastic)
    got, tnfe = tsdes.ab2_sample(ts, tscore, torch.from_numpy(y), N=n,
                                 stochastic=stochastic, noise=noise)
    assert tnfe == jnfe == n
    _close(got, want)


@pytest.mark.parametrize("method", ["euler", "heun", "rk4"])
@pytest.mark.parametrize("sde", ["mix", "ouve"])
def test_ode_sample_matches_jax(sde, method):
    js, ts = _pair(sde)
    jscore, tscore = _score_fns()
    _, y, _ = _data(5)
    key = jax.random.PRNGKey(6)
    want, jnfe = jsdes.ode_sample(js, jscore, key, jnp.asarray(y), N=5,
                                  method=method)
    prior = _normal(jax.random.split(key)[1], (B, 2, T_LEN))
    got, tnfe = tsdes.ode_sample(ts, tscore, torch.from_numpy(y), N=5,
                                 method=method, noise=prior)
    assert tnfe == jnfe
    _close(got, want)


def test_ode_sample_scipy_matches_jax():
    js, ts = _pair("ouve")
    jscore, tscore = _score_fns()
    _, y, _ = _data(6)
    key = jax.random.PRNGKey(7)
    want, jnfe = jsdes.ode_sample_scipy(js, jscore, key, jnp.asarray(y))
    prior = _normal(jax.random.split(key)[1], (B, 2, T_LEN))
    got, tnfe = tsdes.ode_sample_scipy(ts, tscore, torch.from_numpy(y),
                                       noise=prior)
    assert tnfe == jnfe
    _close(got, want)


class _Float64Jnp:
    """``jax.numpy`` as JAX's ``sb_sample`` sees it in the float64
    reference run: its explicit float32 (the widened integrator state) is
    float64, and ``linspace`` builds the float32 grid and widens it, so
    the run keeps JAX's own grid."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def linspace(*args, **kw):
        return jnp.linspace(*args, dtype=jnp.float32, **kw).astype(
            jnp.float64)


def _jax_sb_sample_f64(js, y, sampler_type, monkeypatch):
    """JAX's sb_sample in float64 on its float32 grid, with the linear
    score in float64."""
    from ditsep_tpu.sdes import samplers as jsamplers
    w = np.array([0.9, -0.5]).reshape(1, 2, 1)
    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(jsamplers, "jnp", _Float64Jnp())
        out, _ = jsamplers.sb_sample(
            js, lambda x, t, yy: -x * jnp.asarray(w) + 0.3 * yy * t[
                :, None, None], jax.random.PRNGKey(0),
            jnp.asarray(y, jnp.float64), sampler_type=sampler_type)
        assert out.dtype == jnp.float64
        return np.asarray(out)


@pytest.mark.parametrize("sampler_type", ["ode", "sde"])
@pytest.mark.parametrize("n", [1, 5])
def test_sb_sample_matches_jax(sampler_type, n, monkeypatch):
    """'sde' within 1e-5 of max|ref| of JAX. The 'ode' branch is
    ill-conditioned in float32: its first step weighs the state and y by
    about +-sigma_t sigma_bart / (sigma_T sqrt(eps)) (+-63 at N = 1, +-3600
    at N = 2), which cancel, so two float32 runs that round differently
    part by up to 4e-3 of max|ref|. There JAX's own sb_sample run in
    float64 on its float32 grid is the reference: the port's float64 run
    within 1e-10 of its max, the port's float32 run within twice JAX's
    float32 error against it (and within 1e-5 of max|ref| where JAX
    is)."""
    js, ts = _pair("sbve", N=n)
    jscore, tscore = _score_fns()
    _, y, _ = _data(7)
    key = jax.random.PRNGKey(8)
    want, jnfe = jsdes.sb_sample(js, jscore, key, jnp.asarray(y),
                                 sampler_type=sampler_type)
    steps = np.stack([_normal(k, (B, 2, T_LEN))
                      for k in jax.random.split(key, n)])
    got, tnfe = tsdes.sb_sample(ts, tscore, torch.from_numpy(y),
                                sampler_type=sampler_type, noise=steps)
    assert tnfe == jnfe == n
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    if sampler_type == "sde":
        _close(got, want)
        return
    exact = _jax_sb_sample_f64(js, y, sampler_type, monkeypatch)
    top = np.abs(exact).max()
    w = np.array([0.9, -0.5]).reshape(1, 2, 1)
    port64, _ = tsdes.sb_sample(
        ts, lambda x, t, yy: -x * torch.from_numpy(w) + 0.3 * yy * t[
            :, None, None], torch.from_numpy(y).double(),
        sampler_type=sampler_type)
    assert port64.dtype == torch.float64
    err64 = np.abs(port64.numpy() - exact).max()
    assert err64 <= 1e-10 * top, (err64, top)
    err_jax = np.abs(np.asarray(want) - exact).max()
    err_port = np.abs(got.numpy() - exact).max()
    assert err_port <= max(2 * err_jax, 1e-5 * top), (err_port, err_jax)


def test_samplers_draw_from_the_generator():
    """Without ``noise`` each sampler draws from ``generator`` only: the
    same seed gives the same samples."""
    _, ts = _pair("ouve")
    _, sb = _pair("sbve")
    _, tscore = _score_fns()
    y = torch.from_numpy(_data(8)[1])
    runs = {}
    for seed in (3, 3):
        g = lambda: torch.Generator().manual_seed(seed)  # noqa: E731
        runs.setdefault("ab2", []).append(tsdes.ab2_sample(
            ts, tscore, y, N=4, stochastic=True, generator=g())[0])
        runs.setdefault("ode", []).append(tsdes.ode_sample(
            ts, tscore, y, N=2, generator=g())[0])
        runs.setdefault("sb", []).append(tsdes.sb_sample(
            sb, tscore, y, sampler_type="sde", generator=g())[0])
        runs.setdefault("pc", []).append(tsdes.pc_sample(
            ts, tscore, y, N=3, corrector="ald", schedule="log",
            generator=g())[0])
    for name, (a, b) in runs.items():
        assert torch.equal(a, b) and bool(torch.isfinite(a).all()), name
