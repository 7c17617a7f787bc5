"""Serving load generator: offered concurrency against the batching engine
(port of scripts/serving_bench.py). Runs on the CUDA card unless --cpu is
given; prints one JSON line a level and writes no file.

    python -m ditsep_tpu_torch.scripts.serving_bench \\
        [--config diffsep_icassp | --latent --config latent_diffsep_ouve] \\
        [--levels 1,8,32] [--waves 3] [--mode waves|saturated] [--http] \\
        [--wire-int16] [--pipeline-depth 2] [--sampler pc|ab2] \\
        [--sampler-N 30] [--bf16] [--cpu] [--override a.b=v ...]

Each level builds the production engine (``cli.serve_api.build_engine``,
seeded weights) with ``max_batch`` = the concurrency, runs one untimed
wave (the first calls set up cuDNN), then ``--waves`` timed ones. In the
``waves`` mode each wave submits the level's requests at once and waits
for all of them, so one batch is in flight; ``saturated`` queues every
wave up front, so that ``--pipeline-depth`` >= 2 can overlap a batch's
host copy with the next batch. ``--http`` posts each request as a WAV to
``SeparationAPIServer``'s ``/v1/separate`` on 127.0.0.1 instead of
submitting it to the engine. A row: utt/s, the mean wave latency (or the
makespan), request latency p50 / p95 on the client's clock, the engine's
batches and mean occupancy, and the NFE the sampler reported.

The utterance lengths are the JAX script's: 61,000-65,153 samples on the
waveform path (one 64-frame STFT block, bucket 65,153) and 63,000-65,536
on the latent path (one bucket of 16 VAE hops, 65,536 samples).
"""
from __future__ import annotations

import argparse
import base64
import json
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, List, Sequence
from urllib.request import Request, urlopen

import numpy as np

FS = 8000
MAX_WAIT_MS = 300.0
WAVEFORM_LENGTHS = (61000, 65153)
LATENT_LENGTHS = (63000, 65536)


def utterances(n: int, lengths: Sequence[int], seed: int = 0
               ) -> List[np.ndarray]:
    """``n`` white-noise utterances (0.2 std) of lengths drawn uniformly in
    ``lengths`` = (lo, hi), from ``seed``."""
    rng = np.random.default_rng(seed)
    lo, hi = lengths
    return [(0.2 * rng.standard_normal(int(rng.integers(lo, hi + 1))))
            .astype(np.float32) for _ in range(n)]


class HTTPClient:
    """Requests to a SeparationAPIServer's ``/v1/separate``, each posted
    from a thread of a pool: ``submit(audio)`` returns a Future of the
    (n_src, T) stems decoded from the JSON response."""

    def __init__(self, url: str, fs: int = FS, workers: int = 8,
                 timeout: float = 600.0):
        self.url, self.fs, self.timeout = url, fs, timeout
        self._pool = ThreadPoolExecutor(workers)

    def _post(self, audio: np.ndarray) -> np.ndarray:
        from ditsep_tpu_torch.interface.web import decode_wav, encode_wav
        req = Request(f"{self.url}/v1/separate",
                      data=encode_wav(audio, self.fs),
                      headers={"Content-Type": "audio/wav"})
        with urlopen(req, timeout=self.timeout) as r:
            body = json.loads(r.read())
        return np.stack([decode_wav(base64.b64decode(s))[0][:, 0]
                         for s in body["stems"]])

    def submit(self, audio: np.ndarray) -> Future:
        return self._pool.submit(self._post, audio)

    def get(self, path: str, raw: bool = False):
        with urlopen(f"{self.url}{path}", timeout=60) as r:
            body = r.read()
        return body.decode() if raw else json.loads(body)

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def run_level(submit: Callable[[np.ndarray], Future],
              audios: Sequence[np.ndarray], waves: int,
              mode: str = "waves", timeout: float = 3600.0) -> Dict:
    """Offer ``audios`` as concurrent requests, ``waves`` times, through
    ``submit`` (the engine's, or an HTTPClient's). Returns utt/s, the
    wave latencies (``waves`` mode) or the makespan (``saturated``), the
    requests' latencies p50 / p95 and the stems of the last wave."""
    req_lat: List[float] = []

    def timed(a):
        t = time.perf_counter()
        f = submit(a)
        f.add_done_callback(
            lambda _, t=t: req_lat.append(time.perf_counter() - t))
        return f

    def collect(futs):
        _, not_done = wait(futs, timeout=timeout)
        if not_done:
            raise TimeoutError(f"{len(not_done)} requests not done after "
                               f"{timeout} s")
        return [f.result() for f in futs]

    lat = []
    t0 = time.perf_counter()
    if mode == "saturated":
        outs = collect([timed(a) for _ in range(waves) for a in audios])
        lat.append(time.perf_counter() - t0)
        outs = outs[-len(audios):]
    elif mode == "waves":
        for _ in range(waves):
            t_wave = time.perf_counter()
            outs = collect([timed(a) for a in audios])
            lat.append(time.perf_counter() - t_wave)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    dt = time.perf_counter() - t0
    lat_key = "makespan_s" if mode == "saturated" else "wave_latency_s"
    srt = sorted(req_lat)
    return {"concurrency": len(audios), "waves": waves, "mode": mode,
            "utt_per_s": len(audios) * waves / dt, "seconds": dt,
            lat_key: lat, f"{lat_key}_mean": float(np.mean(lat)),
            "request_latency_p50_s": srt[len(srt) // 2],
            "request_latency_p95_s": srt[min(len(srt) - 1,
                                             int(0.95 * len(srt)))],
            "outputs": outs}


def main(argv=None) -> List[Dict]:
    from ditsep_tpu_torch.cli.common import load_config
    from ditsep_tpu_torch.cli.serve_api import build_engine
    from ditsep_tpu_torch.serving import SeparationAPIServer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None,
                   help="diffsep_icassp (default), or latent_diffsep_ouve "
                        "with --latent")
    p.add_argument("--latent", action="store_true")
    p.add_argument("--levels", default="1,8,32")
    p.add_argument("--waves", type=int, default=3)
    p.add_argument("--mode", choices=("waves", "saturated"), default="waves")
    p.add_argument("--http", action="store_true")
    p.add_argument("--wire-int16", action="store_true")
    p.add_argument("--pipeline-depth", type=int, default=2)
    p.add_argument("--sampler", choices=("pc", "ab2"), default="pc")
    p.add_argument("--sampler-N", type=int, default=30)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--lengths", type=int, nargs=2, default=None,
                   help="utterance length band in samples (default: the "
                        "path's, see above)")
    args = p.parse_args(argv)
    name = args.config or ("latent_diffsep_ouve" if args.latent
                           else "diffsep_icassp")
    lengths = args.lengths or (LATENT_LENGTHS if args.latent
                               else WAVEFORM_LENGTHS)
    rows = []
    for conc in (int(x) for x in args.levels.split(",")):
        cfg = load_config(name, args.override)
        if args.bf16:
            cfg["model"]["score_model"]["dtype"] = "bf16"
        eng = build_engine(cfg, device="cpu" if args.cpu else "cuda",
                           max_batch=max(conc, 1),
                           max_wait_ms=MAX_WAIT_MS, max_seconds=10.0,
                           sampler_N=args.sampler_N, sampler=args.sampler,
                           latent=args.latent, seed=args.seed,
                           wire_int16=args.wire_int16,
                           pipeline_depth=args.pipeline_depth)
        srv = client = None
        try:
            submit = eng.submit
            if args.http:
                srv = SeparationAPIServer(eng, port=0).start()
                client = HTTPClient(f"http://127.0.0.1:{srv.port}",
                                    fs=eng.fs, workers=conc)
                submit = client.submit
            audios = utterances(conc, lengths, seed=args.seed)
            run_level(submit, audios, 1)  # untimed: first-call set-up
            before = eng.stats()
            row = run_level(submit, audios, args.waves, args.mode)
            del row["outputs"]
            st = eng.stats()
            batches = st["batches"] - before["batches"]
            row.update({
                "config": name, "batches": batches,
                "mean_batch_occupancy": (st["batched_items"]
                                         - before["batched_items"])
                / max(batches, 1),
                "pipeline_depth": args.pipeline_depth,
                "wire": "int16" if args.wire_int16 else "f32",
                "http": args.http, "sampler": args.sampler,
                "nfe": eng.separate_fn.nfe})
            rows.append(row)
            print(json.dumps(row), flush=True)
        finally:
            if client is not None:
                client.close()
            if srv is not None:
                srv.close()
            eng.close()
    return rows


if __name__ == "__main__":
    main()
