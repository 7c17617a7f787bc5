"""HTTP API server over :class:`~ditsep_tpu_torch.serving.engine.BatchingEngine`
(port of ditsep_tpu/serving/api.py).

Dependency-free (stdlib ``http.server`` + ``wave``), threaded: each
connection blocks on its request's Future while the engine's single
dispatch thread batches concurrent requests onto the card. The
machine-facing complement of the interactive demo (``interface/web.py``).

Endpoints
---------
- ``GET  /healthz``            -> ``{"ok": true}``
- ``GET  /v1/stats``           -> engine counters (occupancy, latency)
- ``GET  /metrics``            -> the same counters as Prometheus text
- ``POST /v1/separate``        body = WAV bytes; response JSON
  ``{"fs", "n_src", "latency_ms", "stems": [base64 WAV, ...]}``.
  ``?stem=i`` instead returns stem *i* as raw ``audio/wav``.
- ``POST /v1/stream/open``     -> ``{"id", "fs", "n_src",
  "chunk_seconds", "overlap_seconds", "latency_seconds"}``; query may
  override ``chunk_seconds`` / ``overlap_seconds``. Opens a
  bounded-latency streaming session (serving/streaming.py) backed by
  the shared engine, so concurrent sessions ride batched sampler calls.
- ``POST /v1/stream/<id>/push``  body = raw little-endian float32 mono
  samples at the engine rate; response ``{"samples": k, "stems":
  [base64 raw f32, ...]}`` with the newly FINAL separated samples.
- ``POST /v1/stream/<id>/close`` -> same shape, the flushed remainder;
  the session is deleted.

Sample rates must match the engine's (resampling is a client concern —
the reference models are rate-locked too, e.g. 8 kHz Libri2Mix).
"""
from __future__ import annotations

import base64
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ditsep_tpu_torch.interface.web import decode_wav, encode_wav
from ditsep_tpu_torch.serving.engine import BatchingEngine
from ditsep_tpu_torch.serving.streaming import (StreamingSeparator,
                                                engine_separate_fn)


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops the connections of a burst
    # past it, and their clients retry a second later: a wave of
    # concurrent requests then splits across batches
    request_queue_size = 128
    daemon_threads = True


class _StreamSession:
    __slots__ = ("sep", "lock", "last_touch")

    def __init__(self, sep: StreamingSeparator):
        self.sep = sep
        self.lock = threading.Lock()
        self.last_touch = time.monotonic()


class SeparationAPIServer:
    def __init__(self, engine: BatchingEngine, host: str = "127.0.0.1",
                 port: int = 8000, request_timeout: float = 600.0,
                 quiet: bool = True, n_src: int = 2,
                 stream_chunk_seconds: float = 8.0,
                 stream_overlap_seconds: float = 1.0,
                 max_stream_sessions: int = 32,
                 stream_idle_timeout: float = 600.0):
        self.engine = engine
        self.request_timeout = request_timeout
        self.n_src = int(n_src)
        self.stream_chunk_seconds = float(stream_chunk_seconds)
        self.stream_overlap_seconds = float(stream_overlap_seconds)
        self.max_stream_sessions = int(max_stream_sessions)
        self.stream_idle_timeout = float(stream_idle_timeout)
        self._sessions: dict = {}
        self._sessions_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                if not quiet:
                    BaseHTTPRequestHandler.log_message(self, *a)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def _fail(self, msg: str, code=400):
                self._json({"error": msg}, code)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._json({"ok": True})
                elif path == "/v1/stats":
                    st = dict(outer.engine.stats())
                    with outer._sessions_lock:
                        st["open_streams"] = len(outer._sessions)
                    self._json(st)
                elif path == "/metrics":  # Prometheus exposition format
                    self._send(200, outer._prometheus().encode(),
                               "text/plain; version=0.0.4")
                else:
                    self._fail("not found", 404)

            def do_POST(self):
                url = urlparse(self.path)
                # ALWAYS drain the body first: on a keep-alive HTTP/1.1
                # connection an unread body would be parsed as the next
                # request line, desynchronizing the connection
                n = int(self.headers.get("Content-Length", "0"))
                payload = self.rfile.read(n)
                if url.path.startswith("/v1/stream/"):
                    obj, code = outer._stream_request(
                        url.path[len("/v1/stream/"):],
                        parse_qs(url.query), payload)
                    self._json(obj, code)
                    return
                if url.path != "/v1/separate":
                    self._fail("not found", 404)
                    return
                # validate the cheap parts BEFORE spending device time
                qs = parse_qs(url.query)
                stem = None
                if "stem" in qs:
                    try:
                        stem = int(qs["stem"][0])
                    except ValueError:
                        self._fail(f"non-integer stem {qs['stem'][0]!r}")
                        return
                try:
                    audio, fs = decode_wav(payload)
                except Exception as e:
                    self._fail(f"bad WAV payload: {e}")
                    return
                if fs != outer.engine.fs:
                    self._fail(f"sample rate {fs} != engine rate "
                               f"{outer.engine.fs}; resample client-side")
                    return
                mono = audio.mean(axis=1).astype(np.float32)  # (T, C)->(T,)
                t0 = time.perf_counter()
                try:
                    est = outer.engine.separate(
                        mono, timeout=outer.request_timeout)
                except Exception as e:
                    self._fail(f"separation failed: {e}", 500)
                    return
                latency_ms = 1e3 * (time.perf_counter() - t0)
                if stem is not None:
                    i = stem
                    if not 0 <= i < est.shape[0]:
                        self._fail(f"stem {i} out of range "
                                   f"[0, {est.shape[0]})")
                        return
                    self._send(200, encode_wav(est[i], outer.engine.fs),
                               "audio/wav")
                    return
                self._json({
                    "fs": outer.engine.fs,
                    "n_src": int(est.shape[0]),
                    "latency_ms": round(latency_ms, 3),
                    "stems": [base64.b64encode(
                        encode_wav(est[s], outer.engine.fs)).decode()
                        for s in range(est.shape[0])],
                })

        self._httpd = _HTTPServer((host, port), Handler)
        self._thread = None

    # ----------------------------------------------------- streaming --
    def _sweep_sessions(self) -> None:
        """Drop sessions idle past the timeout (caller holds the lock)."""
        now = time.monotonic()
        for sid in [s for s, v in self._sessions.items()
                    if now - v.last_touch > self.stream_idle_timeout]:
            del self._sessions[sid]

    def _stream_request(self, sub: str, qs, payload: bytes):
        """Route ``/v1/stream/<sub>``; returns (json_obj, status)."""
        if sub == "open":
            return self._stream_open(qs)
        sid, _, verb = sub.partition("/")
        with self._sessions_lock:
            sess = self._sessions.get(sid)
        if sess is None:
            return {"error": f"unknown stream {sid!r}"}, 404
        if verb == "push":
            return self._stream_push(sess, payload)
        if verb == "close":
            with self._sessions_lock:
                self._sessions.pop(sid, None)
            return self._stream_flush(sess)
        return {"error": f"unknown stream verb {verb!r}"}, 404

    def _stream_open(self, qs):
        import math

        fs = self.engine.fs
        try:
            chunk_s = float(qs.get("chunk_seconds",
                                   [self.stream_chunk_seconds])[0])
            overlap_s = float(qs.get("overlap_seconds",
                                     [self.stream_overlap_seconds])[0])
            if not (math.isfinite(chunk_s) and math.isfinite(overlap_s)):
                raise ValueError("parameters must be finite")
            chunk = int(chunk_s * fs)
            overlap = int(overlap_s * fs)
        except (ValueError, OverflowError) as e:
            return {"error": f"bad stream parameter: {e}"}, 400
        if not 0 < chunk <= self.engine.max_len:
            return {"error": f"chunk_seconds out of range (0, "
                    f"{self.engine.max_len / fs}]"}, 400
        if not 0 <= overlap < chunk:
            return {"error": "need 0 <= overlap_seconds "
                    "< chunk_seconds"}, 400
        if overlap == 0 and self.n_src > 1:
            # no overlap -> no alignment signal: each window's source
            # order is arbitrary and stems would swap mid-stream
            return {"error": "overlap_seconds must be > 0 for "
                    "multi-source streams (permutation alignment "
                    "needs an overlap)"}, 400
        # pass_lengths unconditionally: engine_separate_fn submits only
        # the window's valid samples, so the flush tail's zero-pad never
        # reaches the engine (which does its own bucket padding and, if
        # configured, lengths masking)
        sep = StreamingSeparator(engine_separate_fn(self.engine),
                                 chunk_samples=chunk,
                                 overlap_samples=overlap,
                                 n_src=self.n_src, pass_lengths=True,
                                 device="cpu")
        with self._sessions_lock:
            self._sweep_sessions()
            if len(self._sessions) >= self.max_stream_sessions:
                return {"error": "too many open streams"}, 429
            sid = uuid.uuid4().hex[:16]
            self._sessions[sid] = _StreamSession(sep)
        return {"id": sid, "fs": fs, "n_src": self.n_src,
                "chunk_seconds": chunk / fs,
                "overlap_seconds": overlap / fs,
                "latency_seconds": sep.latency_samples / fs}, 200

    @staticmethod
    def _stems_json(est: np.ndarray):
        return {"samples": int(est.shape[-1]),
                "stems": [base64.b64encode(
                    np.ascontiguousarray(est[i], np.float32)
                    .tobytes()).decode()
                    for i in range(est.shape[0])]}

    def _stream_push(self, sess: _StreamSession, payload: bytes):
        if len(payload) % 4:
            return {"error": "payload must be little-endian float32 "
                    "mono samples"}, 400
        block = np.frombuffer(payload, dtype="<f4")
        with sess.lock:
            sess.last_touch = time.monotonic()
            try:
                est = sess.sep.push(block)
            except RuntimeError as e:
                return {"error": str(e)}, 409
        return self._stems_json(est), 200

    def _stream_flush(self, sess: _StreamSession):
        with sess.lock:
            est = sess.sep.flush()
        return self._stems_json(est), 200

    def _prometheus(self) -> str:
        """Engine counters in Prometheus text exposition format, so a
        standard scraper can watch batch occupancy / queue depth / tail
        latency without a client library."""
        st = self.engine.stats()
        counters = ["requests", "batches", "batched_items", "padded_rows",
                    "rejected"]
        lines = []
        for c in counters:
            lines.append(f"# TYPE ditsep_{c}_total counter")
            lines.append(f"ditsep_{c}_total {st[c]}")
        lines.append("# TYPE ditsep_pending_requests gauge")
        lines.append(f"ditsep_pending_requests {st['pending']}")
        with self._sessions_lock:
            n_streams = len(self._sessions)
        lines.append("# TYPE ditsep_open_streams gauge")
        lines.append(f"ditsep_open_streams {n_streams}")
        lines.append("# TYPE ditsep_mean_batch_occupancy gauge")
        lines.append(
            f"ditsep_mean_batch_occupancy {st['mean_batch_occupancy']}")
        if "latency_p50_ms" in st:
            lines.append("# TYPE ditsep_request_latency_seconds summary")
            for q, k in (("0.5", "latency_p50_ms"),
                         ("0.95", "latency_p95_ms")):
                lines.append(
                    "ditsep_request_latency_seconds"
                    f'{{quantile="{q}"}} {st[k] / 1e3}')
        return "\n".join(lines) + "\n"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ditsep-api")
        self._thread.start()
        return self

    def serve_forever(self):
        print(f"[serve_api] listening on "
              f"http://{self._httpd.server_address[0]}:{self.port}")
        self._httpd.serve_forever()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
