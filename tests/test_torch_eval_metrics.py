"""The port's metrics (ditsep_tpu_torch.eval: SI-BSS eval, (E)STOI, the
numpy P.862 PESQ, the Hu & Loizou composites and ``compute_metrics``)
against the JAX package's on the same arrays: 1e-5 abs, stated before the
runs. Both are the same numpy and scipy operations in the same order, and
they come out bit-equal: each test also asserts that.
"""
import numpy as np
import pytest

from ditsep_tpu.eval import composite as jax_composite
from ditsep_tpu.eval import metrics as jax_metrics
from ditsep_tpu.eval import pesq_p862 as jax_pesq
from ditsep_tpu_torch.eval import composite, metrics, pesq_p862
from ditsep_tpu_torch.eval import (compute_metrics, pesq_metric,
                                   si_bss_eval_sources, stoi)

FS = 8000


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, want)  # bit-equal (NaN == NaN)


def _sources(n, length, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / FS
    refs = []
    for s in range(n):
        tone = np.sin(2 * np.pi * (180 + 150 * s) * t + s)
        env = 0.5 * (1 + np.sin(2 * np.pi * (1.3 + s) * t))
        refs.append(tone * env + 0.3 * rng.standard_normal(length))
    refs = np.stack(refs)
    est = refs + 0.2 * rng.standard_normal(refs.shape)
    est[0] += 0.3 * refs[-1]  # some interference
    return refs, est


@pytest.mark.parametrize("n,swap", [(2, False), (2, True), (3, False),
                                    (3, True)])
def test_si_bss_eval_sources_matches_jax(n, swap):
    ref, est = _sources(n, 4000, seed=n)
    if swap:  # estimates in another order: the permutation undoes it
        est = est[np.roll(np.arange(n), 1)]
    for kw in ({}, {"zero_mean": True, "clamp_db": 30.0}):
        got = si_bss_eval_sources(ref, est, **kw)
        want = jax_metrics.si_bss_eval_sources(ref, est, **kw)
        for a, b in zip(got, want):
            _same(a, b)
    perm = got[3]
    if swap:
        assert list(perm) != list(range(n))


@pytest.mark.parametrize("extended", [True, False])
def test_stoi_matches_jax(extended):
    ref, est = _sources(2, 3 * FS, seed=5)
    _same(stoi(ref[0], est[0], FS, extended=extended),
          jax_metrics.stoi(ref[0], est[0], FS, extended=extended))
    # shorter than one STOI frame: NaN on both sides
    short = stoi(ref[0, :100], est[0, :100], FS, extended=extended)
    assert np.isnan(short)
    _same(short, jax_metrics.stoi(ref[0, :100], est[0, :100], FS,
                                  extended=extended))


def test_pesq_p862_matches_jax():
    ref, est = _sources(2, 2 * FS, seed=6)
    for mode in ("nb",):
        _same(pesq_p862.pesq(FS, ref[0], est[0], mode),
              jax_pesq.pesq(FS, ref[0], est[0], mode))
    _same(pesq_p862.pesq_raw(ref[1], est[1], FS),
          jax_pesq.pesq_raw(ref[1], est[1], FS))
    _same(pesq_metric(ref[0], est[0], FS),
          jax_metrics.pesq_metric(ref[0], est[0], FS))
    assert metrics.pesq_impl() == jax_metrics.pesq_impl() == "p862_numpy"


def test_composite_matches_jax():
    ref, est = _sources(1, 2 * 16000, seed=7)
    got = composite.eval_composite(ref[0], est[0], 16000)
    want = jax_composite.eval_composite(ref[0], est[0], 16000)
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    for fn in ("ssnr", "llr", "wss"):
        _same(getattr(composite, fn)(ref[0], est[0], 16000),
              getattr(jax_composite, fn)(ref[0], est[0], 16000))


def test_compute_metrics_matches_jax():
    ref, est = _sources(2, 2 * FS, seed=8)
    est = est[::-1].copy()
    got = compute_metrics(est, ref, fs=FS)
    want = jax_metrics.compute_metrics(est, ref, fs=FS)
    assert list(got) == list(want)  # the same keys in the same order
    assert got["pesq_impl"] == want["pesq_impl"] == "p862_numpy"
    assert got["perm"] == want["perm"] == [1, 0]
    for k in ("si_sdr", "si_sir", "si_sar", "pesq", "stoi"):
        _same(got[k], want[k])
