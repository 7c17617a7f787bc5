"""The port's streaming separation (ditsep_tpu_torch.serving.streaming) on
the CPU, mirroring tests/test_streaming.py: the separator returns the TRUE
sources of each window (found by matching the window against the
mixture) in a generator-dependent order; the stitcher must undo every
swap, never revise an emitted sample and reproduce the sources end to
end.

Parity (b): with one deterministic separator on both sides, the port's
``StreamingSeparator`` gives JAX's bit-equal output, block by block, over
random block sizes, flush tails and ``pass_lengths``.
"""
import threading

import numpy as np
import pytest
import torch

from ditsep_tpu.serving import StreamingSeparator as JaxStreamingSeparator
from ditsep_tpu_torch.serving import (BatchingEngine, StreamingSeparator,
                                      engine_separate_fn)

RNG = np.random.default_rng(7)
T = 20000
S = np.stack([RNG.standard_normal(T), RNG.standard_normal(T)]
             ).astype(np.float32)
MIX = S.sum(axis=0)


def _find_offset(c: np.ndarray) -> int:
    L = c.shape[0]
    for s in range(T - L + 1):
        if MIX[s] == c[0] and np.array_equal(MIX[s:s + L], c):
            return s
    raise AssertionError("window not found in mixture")


def _valid(c, lengths):
    if lengths is not None:
        return int(np.asarray(lengths).reshape(-1)[0])
    return np.trim_zeros(c, "b").shape[0]


def _oracle(mix, lengths=None, generator=None):
    """(1,1,C) window (possibly zero-padded tail) -> (1,2,C) true sources,
    swapped when the generator says so."""
    c = mix.numpy().reshape(-1)
    L = _valid(c, lengths)
    s = _find_offset(c[:L])
    out = np.zeros((2, c.shape[0]), np.float32)
    out[:, :L] = S[:, s:s + L]
    if bool(torch.rand((), generator=generator) < 0.5):
        out = out[::-1]
    return torch.from_numpy(out.copy())[None]


def _global_perm_error(est, ref=S):
    ref = ref[:, :est.shape[-1]]
    return min(np.abs(est - ref).max(), np.abs(est[::-1] - ref).max())


def _separator(fn, **kw):
    return StreamingSeparator(fn, chunk_samples=6000, overlap_samples=1000,
                              n_src=2, device="cpu", **kw)


def _stream(blocks, **kw):
    sep = _separator(_oracle, **kw)
    pieces, sizes = [], []
    for b in blocks:
        out = sep.push(b)
        pieces.append(out)
        sizes.append(out.shape[-1])
    pieces.append(sep.flush())
    return np.concatenate(pieces, axis=-1), sizes, sep


def _random_blocks(seed, total=T, hi=4000):
    rng = np.random.default_rng(seed)
    blocks, i = [], 0
    while i < total:
        n = int(rng.integers(1, hi))
        blocks.append(MIX[i:min(i + n, total)])
        i += n
    return blocks


def test_streaming_exact_recovery_random_blocks():
    est, sizes, _ = _stream(_random_blocks(3), seed=1)
    assert est.shape == (2, T)
    assert _global_perm_error(est) < 1e-5
    assert sum(sizes) > T // 2  # mid-stream emission happened


def test_streaming_latency_bound():
    sep = _separator(_oracle, seed=2)
    assert sep.latency_samples == 6000 + 5000
    emitted = 0
    for i in range(0, T, 500):
        emitted += sep.push(MIX[i:i + 500]).shape[-1]
        pushed = min(i + 500, T)
        assert sep.emitted_samples == emitted
        if pushed > sep.latency_samples:
            assert emitted >= pushed - sep.latency_samples
    emitted += sep.flush().shape[-1]
    assert emitted == T


def test_streaming_never_revises_emitted():
    est_a, _, _ = _stream([MIX[:12000], MIX[12000:]], seed=5)
    est_b, _, _ = _stream([MIX[i:i + 100] for i in range(0, T, 100)],
                          seed=5)
    np.testing.assert_allclose(est_a, est_b, atol=1e-6)


def test_streaming_short_stream_pads_and_trims():
    sep = _separator(_oracle, seed=4)
    assert sep.push(MIX[:2500]).shape == (2, 0)
    est = sep.flush()
    assert est.shape == (2, 2500)
    assert _global_perm_error(est) < 1e-5


def test_streaming_pass_lengths_tail():
    seen = []

    def probe(mix, lengths=None, generator=None):
        assert lengths.dtype == torch.int64 and lengths.shape == (1,)
        seen.append(int(lengths[0]))
        return _oracle(mix, lengths, generator)

    sep = _separator(probe, seed=6, pass_lengths=True)
    pieces = [sep.push(MIX[:14000])]
    pieces.append(sep.flush())
    est = np.concatenate(pieces, axis=-1)
    assert est.shape == (2, 14000)
    assert seen == [6000, 6000, 4000]
    assert _global_perm_error(est) < 1e-5


def test_streaming_exact_window_end_no_tail():
    calls = []

    def probe(mix, lengths=None, generator=None):
        calls.append(1)
        return _oracle(mix, lengths, generator)

    sep = _separator(probe, seed=8)
    out = [sep.push(MIX[:11000])]
    out.append(sep.flush())
    est = np.concatenate(out, axis=-1)
    assert est.shape == (2, 11000) and len(calls) == 2
    assert _global_perm_error(est) < 1e-5


def test_streaming_push_after_flush_raises():
    sep = _separator(_oracle)
    sep.flush()
    assert sep.flush().shape == (2, 0)
    with pytest.raises(RuntimeError):
        sep.push(MIX[:10])


def test_streaming_takes_the_given_generator():
    """The windows draw from the given generator in turn (the JAX
    streamer's key), or from one seeded with ``seed``."""
    g = torch.Generator().manual_seed(9)
    est_g, _, _ = _stream([MIX], generator=g)
    est_s, _, _ = _stream([MIX], seed=9)
    np.testing.assert_array_equal(est_g, est_s)
    assert g.get_state().tolist() != torch.Generator().manual_seed(
        9).get_state().tolist()


def test_concurrent_streams_share_batching_engine():
    """Two live streams ride one BatchingEngine (engine_separate_fn):
    windows from both streams share batched calls; each stream still
    reconstructs its own sources exactly."""
    rng = np.random.default_rng(11)
    T2 = 14000
    SRC = {name: np.stack([rng.standard_normal(T2),
                           rng.standard_normal(T2)]).astype(np.float32)
           for name in ("a", "b")}
    MIXES = {name: s.sum(axis=0) for name, s in SRC.items()}

    def batched_oracle(mix, lengths=None, generator=None):
        mix = mix.numpy()
        out = np.zeros((mix.shape[0], 2, mix.shape[-1]), np.float32)
        for r in range(mix.shape[0]):
            c = mix[r].reshape(-1)
            L = np.trim_zeros(c, "b").shape[0]
            hit = None
            for name, m in MIXES.items():
                for s in range(T2 - L + 1):
                    if m[s] == c[0] and np.array_equal(m[s:s + L], c[:L]):
                        hit = (name, s)
                        break
                if hit:
                    break
            assert hit, "window not found in either stream"
            name, s = hit
            row = SRC[name][:, s:s + L]
            if s % 3 == 1:
                row = row[::-1]
            out[r, :, :L] = row
        return torch.from_numpy(out)

    eng = BatchingEngine(batched_oracle, max_batch=4, max_wait_ms=30.0,
                         device="cpu")
    results = {}

    def run_stream(name):
        sep = _separator(engine_separate_fn(eng))
        pieces = [sep.push(MIXES[name][i:i + 1000])
                  for i in range(0, T2, 1000)]
        pieces.append(sep.flush())
        results[name] = np.concatenate(pieces, axis=-1)

    threads = [threading.Thread(target=run_stream, args=(n,))
               for n in MIXES]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.close()
    for name in MIXES:
        est = results[name]
        assert est.shape == (2, T2)
        assert _global_perm_error(est, SRC[name]) < 1e-5, name
    # 3 windows per stream (0, 5000, tail at 10000)
    assert eng.stats()["requests"] == 6


def test_streaming_rejects_zero_overlap_and_multichannel():
    with pytest.raises(ValueError, match="alignment"):
        StreamingSeparator(_oracle, chunk_samples=6000, overlap_samples=0,
                           n_src=2, device="cpu")
    with pytest.raises(ValueError):
        StreamingSeparator(_oracle, chunk_samples=6000,
                           overlap_samples=6000, device="cpu")
    sep = _separator(_oracle)
    with pytest.raises(ValueError, match="mono"):
        sep.push(np.stack([MIX[:100], MIX[:100]]))


# ----------------------------------------------- (b) parity with JAX's
def _det_oracle_np(c, lengths):
    """A deterministic separator: the window's true sources, biased by
    its offset (so that overlapping windows disagree and the crossfade
    counts), swapped when it starts in an odd thousand."""
    L = _valid(c, lengths)
    s = _find_offset(c[:L])
    out = np.zeros((2, c.shape[0]), np.float32)
    out[:, :L] = S[:, s:s + L] + np.float32(0.01 * (s % 7))
    if (s // 1000) % 2:
        out = out[::-1]
    return out[None]


def _jax_det(key, chunk, *lengths):
    return _det_oracle_np(np.asarray(chunk).reshape(-1),
                          lengths[0] if lengths else None)


def _port_det(mix, lengths=None, generator=None):
    return torch.from_numpy(np.ascontiguousarray(_det_oracle_np(
        mix.numpy().reshape(-1),
        None if lengths is None else lengths.numpy())))


@pytest.mark.parametrize("pass_lengths", [False, True])
@pytest.mark.parametrize("seed,total", [(0, T), (1, 14000), (2, 11000),
                                        (3, 2500), (4, 16321)])
def test_streaming_matches_jax_bit_for_bit(pass_lengths, seed, total):
    kw = dict(chunk_samples=6000, overlap_samples=1000, n_src=2,
              pass_lengths=pass_lengths)
    jsep = JaxStreamingSeparator(_jax_det, **kw)
    tsep = StreamingSeparator(_port_det, device="cpu", **kw)
    assert tsep.latency_samples == jsep.latency_samples
    for b in _random_blocks(seed, total, hi=3000):
        want, got = jsep.push(b), tsep.push(b)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert tsep.emitted_samples == jsep.emitted_samples
    want, got = jsep.flush(), tsep.flush()
    np.testing.assert_array_equal(got, want)
    assert tsep.emitted_samples == jsep.emitted_samples == total
