"""The port's serving engine and HTTP API (ditsep_tpu_torch.serving) on the
CPU, mirroring tests/test_serving.py, and held against the JAX package's:

(a) with one deterministic separator on both sides, ``BatchingEngine``
    gives JAX's ``BatchingEngine`` bit-equal stems and equal ``stats()``
    counters, over buckets, padded rows, ``pass_lengths``, both wires and
    pipeline depths 1 and 2;
(d) the API returns byte-equal WAV and JSON stems (the latency field
    aside) and streaming responses for the same payloads;
(e) ``frame_block_padded_len`` equals JAX's for every length in 1..70,000
    at (510, 128, 64).

Served stems of the real samplers against JAX (c) are in
tests/test_torch_serving_models.py; the engine over a mesh of local
devices in tests/test_torch_parallel_eval.py. Every wait here carries a
timeout, and every engine and server is closed in ``finally``.
"""
import base64
import http.client
import json
import signal
import threading
import time
from urllib.error import HTTPError, URLError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from ditsep_tpu.ops.stft import frame_block_padded_len as jax_padded_len
from ditsep_tpu.serving import BatchingEngine as JaxEngine
from ditsep_tpu.serving import SeparationAPIServer as JaxServer
from ditsep_tpu_torch.eval.evaluate import _bucket_lengths_frames
from ditsep_tpu_torch.interface.web import decode_wav, encode_wav
from ditsep_tpu_torch.ops.stft import n_frames_prepadded
from ditsep_tpu_torch.serving import (BatchingEngine, SeparationAPIServer,
                                      frame_block_padded_len)

FRAME_SPEC = (510, 128, 64)
TINY = ["model.score_model.nf=16", "model.score_model.ch_mult=(1,1)",
        "model.score_model.num_res_blocks=1",
        "model.score_model.attn_resolutions=()",
        "model.score_model.n_fft=126", "model.score_model.hop_length=32"]


def _engine(fn, **kw):
    return BatchingEngine(fn, device="cpu", **kw)


def _pointwise_fn(calls=None):
    """Deterministic, batch-pointwise 'separator': stems = (2x, -x).
    Batching requests together must not change any row's result."""
    def fn(mix, lengths=None, generator=None):
        if calls is not None:
            calls.append(int(mix.shape[0]))
        x = mix[:, 0]
        return torch.stack([2.0 * x, -x], dim=1)
    return fn


# --------------------------------------------------------------- buckets
def test_frame_block_padded_len_matches_jax_everywhere():
    """(e): every length 1..70,000 at (510, 128, 64)."""
    for length in range(1, 70001):
        assert (frame_block_padded_len(length, FRAME_SPEC)
                == jax_padded_len(length, *FRAME_SPEC)), length


def test_frame_block_padded_len_properties():
    n_fft, hop, block = FRAME_SPEC
    for L in [1, 1000, 8000, 12345, 32000, 65536]:
        P = frame_block_padded_len(L, FRAME_SPEC)
        assert P >= L
        fL = n_frames_prepadded(L, n_fft, hop)
        fP = n_frames_prepadded(P, n_fft, hop)
        assert -(-fL // block) == -(-fP // block)
        assert n_frames_prepadded(P + 1, n_fft, hop) > -(-fL // block) * block


def test_buckets_agree_with_the_eval_harness():
    """Within an engine bucket no length crosses its 64-frame block, and
    eval/evaluate.py's frame-block buckets group the same lengths."""
    rng = np.random.default_rng(0)
    lengths = [int(x) for x in rng.integers(1, 70000, 400)]
    assigned, merged = _bucket_lengths_frames(lengths, FRAME_SPEC, 10 ** 6)
    assert not merged
    by_engine, by_eval = {}, {}
    for i, L in enumerate(lengths):
        by_engine.setdefault(frame_block_padded_len(L, FRAME_SPEC),
                             set()).add(i)
        by_eval.setdefault(assigned[i], set()).add(i)
    assert sorted(map(sorted, by_engine.values())) == sorted(
        map(sorted, by_eval.values()))
    for blen, idxs in by_engine.items():
        assert all(lengths[i] <= blen for i in idxs)
        assert max(lengths[i] for i in idxs) <= blen


def test_bucket_of_sample_domain():
    eng = _engine(_pointwise_fn(), frame_spec=None, bucket_multiple=4096,
                  max_wait_ms=1.0)
    try:
        assert eng.bucket_of(1) == 4096
        assert eng.bucket_of(4096) == 4096
        assert eng.bucket_of(4097) == 8192
    finally:
        eng.close()


# ---------------------------------------------------------------- engine
def test_engine_batches_concurrent_requests():
    calls = []
    eng = _engine(_pointwise_fn(calls), max_batch=8, max_wait_ms=60.0)
    try:
        rng = np.random.default_rng(0)
        base = 8000
        lens = [base, base + 10, base + 64, base + 100]
        audios = [rng.standard_normal(L).astype(np.float32) for L in lens]
        futs = [eng.submit(a) for a in audios]
        outs = [f.result(timeout=30) for f in futs]
        for a, o in zip(audios, outs):
            assert o.shape == (2, a.shape[-1])
            np.testing.assert_allclose(o[0], 2.0 * a, rtol=1e-6)
            np.testing.assert_allclose(o[1], -a, rtol=1e-6)
        st = eng.stats()
        assert st["requests"] == 4
        assert st["batches"] == 1
        assert st["mean_batch_occupancy"] == 4.0
        assert calls == [4]
    finally:
        eng.close()


def test_engine_separate_buckets_dispatch_separately():
    eng = _engine(_pointwise_fn(), max_batch=4, max_wait_ms=20.0)
    try:
        f1 = eng.submit(np.ones(4000, np.float32))
        f2 = eng.submit(np.ones(40000, np.float32))
        o1, o2 = f1.result(timeout=30), f2.result(timeout=30)
        assert o1.shape == (2, 4000) and o2.shape == (2, 40000)
        assert eng.stats()["batches"] == 2
    finally:
        eng.close()


def test_engine_full_batch_dispatches_early():
    eng = _engine(_pointwise_fn(), max_batch=2, max_wait_ms=10_000.0)
    try:
        a = np.ones(4000, np.float32)
        t0 = time.perf_counter()
        futs = [eng.submit(a), eng.submit(a)]
        for f in futs:
            f.result(timeout=30)
        assert time.perf_counter() - t0 < 5.0
    finally:
        eng.close()


def test_engine_rejects_out_of_range_and_recovers_from_errors():
    def flaky(mix, lengths=None, generator=None):
        if mix.shape[0] >= 2:
            raise RuntimeError("boom")
        x = mix[:, 0]
        return torch.stack([x, x], dim=1)

    eng = _engine(flaky, max_batch=2, max_wait_ms=30.0, max_seconds=1.0,
                  fs=8000)
    try:
        with pytest.raises(ValueError):
            eng.submit(np.ones(9000, np.float32)).result(timeout=5)
        f1 = eng.submit(np.ones(4000, np.float32))
        f2 = eng.submit(np.ones(4000, np.float32))
        with pytest.raises(RuntimeError):
            f1.result(timeout=30)
        with pytest.raises(RuntimeError):
            f2.result(timeout=30)
        time.sleep(0.05)  # let the failed batch fully retire
        out = eng.separate(np.ones(4000, np.float32), timeout=30)
        assert out.shape == (2, 4000)
        assert eng.stats()["rejected"] == 1
    finally:
        eng.close()


def test_engine_close_rejects_new_and_pending():
    eng = _engine(_pointwise_fn(), max_wait_ms=50.0)
    eng.close()
    with pytest.raises(RuntimeError):
        eng.submit(np.ones(100, np.float32)).result(timeout=5)


def test_engine_power_of_two_padding_counted():
    calls = []
    eng = _engine(_pointwise_fn(calls), max_batch=8, max_wait_ms=40.0)
    try:
        assert eng.batch_sizes == [1, 2, 4, 8]
        a = np.ones(4000, np.float32)
        futs = [eng.submit(a) for _ in range(3)]  # -> padded to 4
        for f in futs:
            f.result(timeout=30)
        assert eng.stats()["padded_rows"] == 1 and calls == [4]
    finally:
        eng.close()


@pytest.mark.parametrize("entry", ["engine", "serve_api"])
def test_mesh_raises(entry, monkeypatch):
    """What a mesh refuses: the engine splits batches over the devices of
    one process (a mesh of several processes raises), and ``--mesh``
    without a card and without --cpu raises (no fallback to the CPU)."""
    from ditsep_tpu_torch import parallel
    if entry == "engine":
        mesh = parallel.Mesh(
            devices=np.array([torch.device("cpu")] * 2, object),
            axis_names=("data",), group=None, rank=0, world_size=2,
            local=(torch.device("cpu"),))
        with pytest.raises(ValueError, match="one process"):
            _engine(_pointwise_fn(), mesh=mesh)
    else:
        from ditsep_tpu_torch.cli import serve_api
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_api.main(["--mesh"])


def test_engine_full_bucket_not_blocked_by_straggler():
    eng = _engine(_pointwise_fn(), max_batch=2, max_wait_ms=10_000.0)
    try:
        lone = eng.submit(np.ones(40000, np.float32))  # bucket A, alone
        t0 = time.perf_counter()
        futs = [eng.submit(np.ones(4000, np.float32)) for _ in range(2)]
        for f in futs:
            f.result(timeout=30)
        assert time.perf_counter() - t0 < 5.0
        assert not lone.done()
    finally:
        eng.close()
        try:
            lone.result(timeout=10)
        except RuntimeError:
            pass


def test_engine_warmup_covers_all_batch_sizes():
    calls = []
    eng = _engine(_pointwise_fn(calls), max_batch=4, max_wait_ms=1.0)
    try:
        eng.warmup([4000])
        assert sorted(calls) == [1, 2, 4]
    finally:
        eng.close()


def test_engine_pass_lengths_forwards_true_lengths():
    got = {}

    def fn(mix, lengths=None, generator=None):
        got["lens"] = lengths.tolist()
        got["dtype"] = lengths.dtype
        x = mix[:, 0]
        return torch.stack([x, x], dim=1)

    eng = _engine(fn, max_batch=2, max_wait_ms=40.0, pass_lengths=True)
    try:
        f1 = eng.submit(np.ones(4000, np.float32))
        f2 = eng.submit(np.ones(4100, np.float32))
        f1.result(timeout=30), f2.result(timeout=30)
        assert sorted(got["lens"]) == [4000, 4100]
        assert got["dtype"] == torch.int64
    finally:
        eng.close()


def test_engine_runs_in_inference_mode_with_its_generator():
    """Grad mode is per thread: the dispatch thread runs separate_fn in
    inference mode, and hands it the engine's own generator."""
    seen = {}

    def fn(mix, lengths=None, generator=None):
        seen["inference"] = torch.is_inference_mode_enabled()
        seen["generator"] = generator
        return torch.stack([mix[:, 0], mix[:, 0]], dim=1)

    eng = _engine(fn, max_batch=1, max_wait_ms=1.0, seed=3)
    try:
        eng.separate(np.ones(100, np.float32), timeout=30)
        assert seen["inference"] and seen["generator"] is eng._generator
        assert seen["generator"].initial_seed() == 3
    finally:
        eng.close()


def test_engine_cold_bucket_not_starved_by_hot_bucket():
    def slow_fn(mix, lengths=None, generator=None):
        time.sleep(0.05)
        x = mix[:, 0]
        return torch.stack([x, x], dim=1)

    eng = _engine(slow_fn, max_batch=2, max_wait_ms=150.0)
    stop = threading.Event()

    def hot_load():
        while not stop.is_set():
            eng.submit(np.ones(4000, np.float32))
            eng.submit(np.ones(4000, np.float32))
            time.sleep(0.02)

    t = threading.Thread(target=hot_load, daemon=True)
    try:
        t.start()
        time.sleep(0.1)
        cold = eng.submit(np.ones(40000, np.float32))
        cold.result(timeout=5)
    finally:
        stop.set()
        t.join(timeout=5)
        eng.close()
    assert not t.is_alive()


def test_engine_wire_int16_fidelity():
    eng = _engine(_pointwise_fn(), max_batch=4, max_wait_ms=30.0,
                  wire_int16=True)
    try:
        rng = np.random.default_rng(3)
        audios = [rng.uniform(-0.4, 0.4, size=L).astype(np.float32)
                  for L in (8000, 8010)]
        outs = [f.result(timeout=60)
                for f in [eng.submit(a) for a in audios]]
        for a, o in zip(audios, outs):
            assert o.shape == (2, a.shape[-1])
            assert o.dtype == np.float32
            np.testing.assert_allclose(o[0], 2.0 * a, atol=3.5 / 32768)
            np.testing.assert_allclose(o[1], -a, atol=2.5 / 32768)
    finally:
        eng.close()


def test_engine_pipeline_depth_invariance():
    """pipeline_depth only changes scheduling: results and the generator's
    stream are bit-identical at any depth (draws in dispatch order)."""
    def sep(mix, lengths=None, generator=None):
        x = mix[:, 0]
        noise = torch.randn(x.shape, generator=generator)
        return torch.stack([x + noise, x - noise], dim=1)

    rng = np.random.default_rng(11)
    audios = [rng.standard_normal(5000).astype(np.float32)
              for _ in range(12)]
    results = []
    for depth in (1, 2, 3):
        eng = _engine(sep, max_batch=4, max_wait_ms=500.0, seed=42,
                      pipeline_depth=depth)
        try:
            futs = [eng.submit(a) for a in audios]
            results.append([f.result(timeout=120) for f in futs])
            assert eng.stats()["batches"] == 3
        finally:
            eng.close()
    for serial, *piped in zip(*results):
        for p in piped:
            np.testing.assert_array_equal(serial, p)


class _SlowRead:
    """Estimates whose host copy completes ``delay`` s after the call
    (a device-to-host copy): ``_finalize`` reads them with np.asarray."""

    def __init__(self, value, delay, log):
        self._value, self._t = value, time.perf_counter() + delay
        self._log = log

    def __array__(self, dtype=None, copy=None):
        rem = self._t - time.perf_counter()
        if rem > 0:
            time.sleep(rem)
        self._log.append(("read", time.perf_counter()))
        return self._value if dtype is None else self._value.astype(dtype)


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_pipelined_overlaps_reads(depth):
    """With depth >= 2 the dispatch thread runs batch k+1 before batch k's
    host copy completes; with depth 1 it waits for it. Asserted by the
    order of events, not by wall-clock margins."""
    log = []

    def sep(mix, lengths=None, generator=None):
        log.append(("dispatch", time.perf_counter()))
        x = mix[:, 0].numpy()
        return _SlowRead(np.stack([2.0 * x, -x], axis=1), 0.3, log)

    rng = np.random.default_rng(5)
    audios = [rng.standard_normal(5000).astype(np.float32)
              for _ in range(4)]
    eng = _engine(sep, max_batch=2, max_wait_ms=500.0, pipeline_depth=depth)
    try:
        outs = [f.result(timeout=60) for f in
                [eng.submit(a) for a in audios]]
        for a, o in zip(audios, outs):
            np.testing.assert_allclose(o[0], 2.0 * a, rtol=1e-6)
    finally:
        eng.close()
    kinds = [k for k, _ in log]
    assert kinds.count("dispatch") == 2 and kinds.count("read") == 2
    overlapped = kinds.index("dispatch", 1) < kinds.index("read")
    assert overlapped == (depth == 2)


def test_engine_pipeline_depth_bounds_inflight():
    gate = threading.Event()
    dispatched = []

    class GatedRead:
        def __init__(self, value):
            self._v = value

        def __array__(self, dtype=None, copy=None):
            gate.wait(30)
            return self._v

    def sep(mix, lengths=None, generator=None):
        x = mix[:, 0].numpy()
        dispatched.append(1)
        return GatedRead(np.stack([2.0 * x, -x], axis=1))

    eng = _engine(sep, max_batch=1, max_wait_ms=5.0, pipeline_depth=2)
    try:
        futs = [eng.submit(np.zeros(4000, np.float32)) for _ in range(5)]
        deadline = time.perf_counter() + 30.0
        while len(dispatched) < 2 and time.perf_counter() < deadline:
            time.sleep(0.02)
        time.sleep(0.5)  # grace: a 3rd dispatch would land in here
        assert len(dispatched) == 2
        gate.set()
        for f in futs:
            assert f.result(timeout=30).shape == (2, 4000)
        assert len(dispatched) == 5
    finally:
        gate.set()
        eng.close()


def _wedged_engine(gate, max_batch):
    class WedgedRead:
        def __init__(self, value):
            self._v = value

        def __array__(self, dtype=None, copy=None):
            gate.wait(30)
            return self._v

    def sep(mix, lengths=None, generator=None):
        x = mix[:, 0].numpy()
        return WedgedRead(np.stack([2.0 * x, -x], axis=1))

    return _engine(sep, max_batch=max_batch, max_wait_ms=5.0,
                   pipeline_depth=2)


def test_engine_close_fails_inflight_on_wedged_read():
    gate = threading.Event()
    eng = _wedged_engine(gate, max_batch=2)
    futs = [eng.submit(np.zeros(4000, np.float32)) for _ in range(2)]
    time.sleep(0.4)  # batch dispatched; completer stuck in the read
    eng.close(timeout=0.8)
    try:
        for f in futs:
            with pytest.raises(RuntimeError):
                f.result(timeout=5)
    finally:
        gate.set()  # the daemon completer's late set_result is a no-op
    time.sleep(0.2)


def test_engine_close_fails_batch_held_at_the_semaphore():
    """Both slots wedged in host copies and a third batch taken from the
    queue: that batch waits at the semaphore, in neither the queue nor a
    copy, and close() must fail it too (the JAX engine leaves it, its
    caller blocked for ever)."""
    gate = threading.Event()
    eng = _wedged_engine(gate, max_batch=1)
    futs = [eng.submit(np.zeros(4000, np.float32)) for _ in range(3)]
    deadline = time.perf_counter() + 30.0
    while eng.stats()["pending"] and time.perf_counter() < deadline:
        time.sleep(0.02)
    time.sleep(0.2)  # the third is taken, and held at the semaphore
    assert eng.stats()["pending"] == 0
    eng.close(timeout=0.8)
    try:
        for f in futs:
            with pytest.raises(RuntimeError, match="closed"):
                f.result(timeout=5)
    finally:
        gate.set()
    time.sleep(0.2)


# ----------------------------------------------- (a) parity with JAX's
def _np_separator(x, lens):
    """A deterministic row-wise separator in numpy: its result depends on
    the row, its padded length and (given) its valid length."""
    out = np.stack([1.5 * x + 0.25 * np.roll(x, 1, axis=-1),
                    0.125 - 0.75 * x], axis=1).astype(np.float32)
    if lens is not None:
        out[:, 1] += (np.asarray(lens, np.float32)
                      / np.float32(x.shape[-1]))[:, None]
    return out


def _jax_fn(key, mix, *lens):
    return _np_separator(np.asarray(mix)[:, 0],
                         np.asarray(lens[0]) if lens else None)


def _port_fn(mix, lengths=None, generator=None):
    return torch.from_numpy(_np_separator(
        mix[:, 0].numpy(), None if lengths is None else lengths.numpy()))


def _outcomes(eng, audios):
    futs = [eng.submit(a) for a in audios]
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=60))
        except ValueError as e:
            out.append(type(e))
    return out


@pytest.mark.parametrize("pass_lengths", [False, True])
@pytest.mark.parametrize("wire_int16", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_engine_matches_jax_bit_for_bit(pass_lengths, wire_int16, depth):
    rng = np.random.default_rng(7)
    # 3 in a 20,000-sample block (padded to 4 after max_wait), 1 alone, 1
    # rejected as too long, then 4 in a 4000-sample block (full: it goes
    # at once, after every other request is queued)
    lengths = [20000, 19800, 20100, 9000, 90000, 4000, 3900, 4100, 3950]
    audios = [(0.6 * rng.standard_normal(L)).astype(np.float32)
              for L in lengths]
    kw = dict(max_batch=4, max_wait_ms=400.0, max_seconds=10.0,
              pass_lengths=pass_lengths, wire_int16=wire_int16,
              pipeline_depth=depth, seed=1)
    results, stats = [], []
    for eng in (JaxEngine(_jax_fn, **kw), _engine(_port_fn, **kw)):
        try:
            results.append(_outcomes(eng, audios))
            st = eng.stats()
        finally:
            eng.close()
        stats.append({k: st[k] for k in ("requests", "batches",
                                         "batched_items", "padded_rows",
                                         "rejected", "pending",
                                         "mean_batch_occupancy")})
    assert stats[0] == stats[1] == {
        "requests": 8, "batches": 3, "batched_items": 8, "padded_rows": 1,
        "rejected": 1, "pending": 0, "mean_batch_occupancy": 8 / 3}
    for want, got in zip(*results):
        if want is ValueError:
            assert got is ValueError
        else:
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ API
def test_api_server_roundtrip():
    eng = _engine(_pointwise_fn(), max_wait_ms=5.0)
    srv = SeparationAPIServer(eng, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with urlopen(f"{url}/healthz", timeout=10) as r:
            assert json.loads(r.read())["ok"] is True
        audio = (0.25 * np.sin(np.linspace(0, 100, 8000))
                 ).astype(np.float32)
        wav = encode_wav(audio, 8000)
        req = Request(f"{url}/v1/separate", data=wav,
                      headers={"Content-Type": "audio/wav"})
        with urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["n_src"] == 2 and body["fs"] == 8000
        stem0, fs0 = decode_wav(base64.b64decode(body["stems"][0]))
        assert fs0 == 8000
        np.testing.assert_allclose(stem0[:, 0], 2.0 * audio, atol=2e-4)
        req = Request(f"{url}/v1/separate?stem=1", data=wav,
                      headers={"Content-Type": "audio/wav"})
        with urlopen(req, timeout=60) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            stem1, _ = decode_wav(r.read())
        np.testing.assert_allclose(stem1[:, 0], -audio, atol=2e-4)
        with urlopen(f"{url}/v1/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert st["requests"] == 2 and st["open_streams"] == 0
    finally:
        srv.close()
        eng.close()


def test_api_server_rejects_bad_rate_and_payload():
    eng = _engine(_pointwise_fn(), max_wait_ms=5.0, fs=8000)
    srv = SeparationAPIServer(eng, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/v1/separate"
        wav16k = encode_wav(np.ones(16000, np.float32), 16000)
        with pytest.raises(HTTPError) as ei:
            urlopen(Request(url, data=wav16k), timeout=30)
        assert ei.value.code == 400
        assert "sample rate" in json.loads(ei.value.read())["error"]
        with pytest.raises(HTTPError) as ei:
            urlopen(Request(url, data=b"not a wav"), timeout=30)
        assert ei.value.code == 400
        wav8k = encode_wav(np.ones(4000, np.float32), 8000)
        with pytest.raises(HTTPError) as ei:
            urlopen(Request(url + "?stem=abc", data=wav8k), timeout=30)
        assert ei.value.code == 400
        with pytest.raises(HTTPError) as ei:
            urlopen(Request(url + "?stem=5", data=wav8k), timeout=30)
        assert ei.value.code == 400  # out of range, after separation
        assert eng.stats()["requests"] == 1
    finally:
        srv.close()
        eng.close()


def test_api_keepalive_connection_survives_404_with_body():
    eng = _engine(_pointwise_fn(), max_wait_ms=5.0)
    srv = SeparationAPIServer(eng, port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            wav = encode_wav(np.ones(4000, np.float32), 8000)
            conn.request("POST", "/wrong/path", body=wav)
            r1 = conn.getresponse()
            assert r1.status == 404
            r1.read()
            conn.request("POST", "/v1/separate", body=wav)
            r2 = conn.getresponse()
            assert r2.status == 200
            assert json.loads(r2.read())["n_src"] == 2
        finally:
            conn.close()
    finally:
        srv.close()
        eng.close()


def test_api_prometheus_metrics():
    eng = _engine(_pointwise_fn(), max_wait_ms=5.0)
    srv = SeparationAPIServer(eng, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        wav = encode_wav(np.ones(4000, np.float32), 8000)
        with urlopen(Request(f"{url}/v1/separate", data=wav),
                     timeout=60) as r:
            json.loads(r.read())
        with urlopen(f"{url}/metrics", timeout=10) as r:
            assert "text/plain" in r.headers["Content-Type"]
            body = r.read().decode()
        assert "ditsep_requests_total 1" in body
        assert "ditsep_batches_total 1" in body
        assert "# TYPE ditsep_pending_requests gauge" in body
        assert "ditsep_open_streams 0" in body
        assert 'ditsep_request_latency_seconds{quantile="0.5"}' in body
    finally:
        srv.close()
        eng.close()


def test_api_concurrent_requests_batch():
    eng = _engine(_pointwise_fn(), max_batch=4, max_wait_ms=300.0)
    srv = SeparationAPIServer(eng, port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/v1/separate"
        rng = np.random.default_rng(2)
        audios = [0.2 * rng.standard_normal(8000).astype(np.float32)
                  for _ in range(4)]
        results = [None] * 4

        def post(i):
            req = Request(url, data=encode_wav(audios[i], 8000))
            with urlopen(req, timeout=60) as r:
                results[i] = json.loads(r.read())

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for i, body in enumerate(results):
            stem, _ = decode_wav(base64.b64decode(body["stems"][0]))
            np.testing.assert_allclose(stem[:, 0],
                                       np.clip(2.0 * audios[i], -1.0, 1.0),
                                       atol=2e-4)
        assert eng.stats()["batches"] < 4
        # a burst of connections past socketserver's backlog of 5 would
        # wait for the clients' one-second retry and miss the batch
        assert srv._httpd.request_queue_size >= 64
    finally:
        srv.close()
        eng.close()


def _post_json(url, data=b""):
    with urlopen(Request(url, data=data), timeout=30) as r:
        return json.loads(r.read())


def test_api_server_streaming_session():
    """open -> push raw f32 blocks -> close; the pointwise separator makes
    the expected output exact."""
    eng = _engine(_pointwise_fn(), max_wait_ms=5.0)
    srv = SeparationAPIServer(eng, port=0, n_src=2,
                              stream_chunk_seconds=0.75,
                              stream_overlap_seconds=0.125).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        meta = _post_json(f"{url}/v1/stream/open")
        assert meta["fs"] == 8000 and meta["n_src"] == 2
        assert meta["chunk_seconds"] == 0.75
        assert meta["latency_seconds"] == (6000 + 5000) / 8000
        sid = meta["id"]
        with urlopen(f"{url}/v1/stats", timeout=10) as r:
            assert json.loads(r.read())["open_streams"] == 1
        rng = np.random.default_rng(0)
        mix = (rng.standard_normal(15000) * 0.2).astype(np.float32)
        pieces = []
        for s in range(0, 15000, 4000):
            out = _post_json(f"{url}/v1/stream/{sid}/push",
                             mix[s:s + 4000].tobytes())
            pieces.append(np.stack([
                np.frombuffer(base64.b64decode(b), dtype="<f4")
                for b in out["stems"]]))
            assert out["samples"] == pieces[-1].shape[-1]
        out = _post_json(f"{url}/v1/stream/{sid}/close")
        pieces.append(np.stack([
            np.frombuffer(base64.b64decode(b), dtype="<f4")
            for b in out["stems"]]))
        est = np.concatenate(pieces, axis=-1)
        assert est.shape == (2, 15000)
        np.testing.assert_allclose(est[0], 2.0 * mix, atol=1e-5)
        np.testing.assert_allclose(est[1], -mix, atol=1e-5)

        with pytest.raises(HTTPError) as e:
            _post_json(f"{url}/v1/stream/{sid}/push", b"\x00" * 8)
        assert e.value.code == 404
        meta2 = _post_json(f"{url}/v1/stream/open?chunk_seconds=0.5")
        with pytest.raises(HTTPError) as e:
            _post_json(f"{url}/v1/stream/{meta2['id']}/push", b"\x00" * 3)
        assert e.value.code == 400
        with pytest.raises(HTTPError) as e:
            _post_json(f"{url}/v1/stream/{meta2['id']}/nope")
        assert e.value.code == 404
        for bad in ("chunk_seconds=1e9", "chunk_seconds=nan",
                    "chunk_seconds=inf", "overlap_seconds=0",
                    "chunk_seconds=abc"):
            with pytest.raises(HTTPError) as e:
                _post_json(f"{url}/v1/stream/open?{bad}")
            assert e.value.code == 400, bad
    finally:
        srv.close()
        eng.close()


def test_api_stream_session_cap_and_idle_sweep():
    eng = _engine(_pointwise_fn(), max_wait_ms=5.0)
    srv = SeparationAPIServer(eng, port=0, max_stream_sessions=2,
                              stream_chunk_seconds=0.5,
                              stream_overlap_seconds=0.125,
                              stream_idle_timeout=0.3).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        ids = [_post_json(f"{url}/v1/stream/open")["id"] for _ in range(2)]
        with pytest.raises(HTTPError) as e:
            _post_json(f"{url}/v1/stream/open")
        assert e.value.code == 429
        time.sleep(0.5)  # both idle past the timeout: swept at next open
        _post_json(f"{url}/v1/stream/open")
        with pytest.raises(HTTPError) as e:
            _post_json(f"{url}/v1/stream/{ids[0]}/push", b"")
        assert e.value.code == 404
    finally:
        srv.close()
        eng.close()


def test_install_graceful_shutdown_drains():
    from ditsep_tpu_torch.cli.serve_api import install_graceful_shutdown

    calls = []

    def slow_fn(mix, lengths=None, generator=None):
        calls.append(int(mix.shape[0]))
        time.sleep(0.2)
        x = mix[:, 0]
        return torch.stack([2.0 * x, -x], dim=1)

    eng = _engine(slow_fn, max_wait_ms=500.0, max_batch=4)
    srv = SeparationAPIServer(eng, port=0).start()
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        install_graceful_shutdown(srv, eng)
        port = srv.port
        fut = eng.submit(np.ones(4000, np.float32) * 0.1)
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        est = fut.result(timeout=30)
        assert est.shape[0] == 2 and calls
        deadline = time.time() + 10
        down = False
        while time.time() < deadline and not down:
            try:
                urlopen(f"http://127.0.0.1:{port}/healthz", timeout=1)
                time.sleep(0.1)
            except (URLError, ConnectionError, OSError):
                down = True
        assert down
    finally:
        for s, h in old.items():
            signal.signal(s, h)
        srv.close()
        eng.close()


# ----------------------------------------------- (d) parity with JAX's
def _strip_latency(body):
    return {k: v for k, v in json.loads(body).items() if k != "latency_ms"}


def _api_exchange(server_cls, engine):
    """One /v1/separate (JSON and ?stem=1) and one streaming session
    against a server; the raw response bodies."""
    srv = server_cls(engine, port=0, stream_chunk_seconds=0.5,
                     stream_overlap_seconds=0.125).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        rng = np.random.default_rng(12)
        audio = (0.4 * rng.standard_normal(7000)).astype(np.float32)
        wav = encode_wav(np.stack([audio, 0.5 * audio]), 8000)  # stereo
        out = {}
        with urlopen(Request(f"{url}/v1/separate", data=wav),
                     timeout=60) as r:
            out["json"] = _strip_latency(r.read())
        with urlopen(Request(f"{url}/v1/separate?stem=1", data=wav),
                     timeout=60) as r:
            out["wav"] = r.read()
        meta = _post_json(f"{url}/v1/stream/open")
        out["open"] = {k: v for k, v in meta.items() if k != "id"}
        stream = (0.3 * rng.standard_normal(11000)).astype(np.float32)
        out["push"] = [
            _post_json(f"{url}/v1/stream/{meta['id']}/push",
                       stream[s:s + 2500].tobytes())
            for s in range(0, stream.shape[-1], 2500)]
        out["close"] = _post_json(f"{url}/v1/stream/{meta['id']}/close")
        return out
    finally:
        srv.close()


@pytest.mark.parametrize("pass_lengths", [False, True])
def test_api_matches_jax_byte_for_byte(pass_lengths):
    kw = dict(max_batch=2, max_wait_ms=5.0, pass_lengths=pass_lengths)
    out = []
    for server_cls, eng in ((JaxServer, JaxEngine(_jax_fn, **kw)),
                            (SeparationAPIServer, _engine(_port_fn, **kw))):
        try:
            out.append(_api_exchange(server_cls, eng))
        finally:
            eng.close()
    want, got = out
    assert got["wav"] == want["wav"]
    assert got == want
    assert len(got["push"]) == 5 and got["close"]["samples"] > 0


# ----------------------------------------------------------- build_engine
def test_build_engine_mask_padding_api_e2e():
    """cli/serve_api.build_engine wires trainer.separate with per-request
    lengths behind the HTTP API, end to end."""
    from ditsep_tpu_torch.cli.common import load_config
    from ditsep_tpu_torch.cli.serve_api import build_engine

    eng = build_engine(load_config("diffsep", TINY), device="cpu",
                       sampler_N=2, mask_padding=True, max_batch=2,
                       max_wait_ms=40.0)
    srv = SeparationAPIServer(eng, port=0).start()
    try:
        assert eng.pass_lengths and eng.frame_spec == (126, 32, 64)
        rng = np.random.default_rng(3)
        wav = encode_wav(0.2 * rng.standard_normal(4000)
                         .astype(np.float32), 8000)
        req = Request(f"http://127.0.0.1:{srv.port}/v1/separate", data=wav)
        with urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["n_src"] == 2
        for stem_b64 in body["stems"]:
            stem, fs = decode_wav(base64.b64decode(stem_b64))
            assert fs == 8000 and stem.shape[0] == 4000
            assert np.isfinite(stem).all()
        assert eng.separate_fn.nfe == 4
    finally:
        srv.close()
        eng.close()


def test_build_engine_requires_cuda_unless_cpu(monkeypatch):
    from ditsep_tpu_torch.cli.common import load_config
    from ditsep_tpu_torch.cli.serve_api import build_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(load_config("diffsep", TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchingEngine(_pointwise_fn())
