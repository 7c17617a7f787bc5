"""Streaming-separation benchmark (port of scripts/streaming_bench.py): the
bounded-latency real-time path (``serving/streaming.py``) with the flagship
sampler. Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.scripts.streaming_bench \\
        [--stream-seconds 120] [--nf 128] [--sampler-N 30] [--f32] \\
        [--out result.json] [--cpu]

A white-noise mixture (0.1 std, from seed 0) of ``--stream-seconds``
(default: the ``STREAM_BENCH_SECONDS`` environment variable, else 120) is
pushed in 0.25 s blocks through ``StreamingSeparator`` with 8 s windows and
1 s of overlap. Each window is the flagship score model (nf=128, 7 levels,
attention at 16, bf16 compute; seeded weights) under ``pc_sample``: MixSDE,
N=30, snr 0.5, the ald2 corrector with one step, denoise (NFE 60), timed to
``torch.cuda.synchronize()``; one untimed window first (cuDNN's set-up).
Prints one JSON line with the JAX script's keys (``stream_seconds`` ...
``latency_budget_s``, ``note``); writes it to a file only with ``--out``.
On the card each score evaluation launches ``fir_down2d`` 18 times.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import numpy as np

FS = 8000
CHUNK_S = 8.0
OVERLAP_S = 1.0
BLOCK_S = 0.25


def flagship_model(nf: int, dtype: str, device):
    """The flagship score model (7 levels, attention at 16) at width
    ``nf``, seeded weights, in eval mode on ``device``."""
    from ditsep_tpu_torch.configs.build import build_score_model
    return build_score_model(
        {"kind": "ScoreModelNCSNpp", "num_sources": 2, "nf": nf,
         "ch_mult": (1, 1, 2, 2, 2, 2, 2), "attn_resolutions": (16,),
         "image_size": 256, "dtype": dtype}, device=device, seed=0)


def run(stream_s: float, *, nf: int = 128, n_steps: int = 30,
        dtype: str = "bf16", device: str = "cuda") -> Tuple[Dict, Dict]:
    """The benchmark: its result (the JAX script's keys) and the NFE of the
    warm-up window (``warmup``) and of each timed window (``windows``)."""
    import torch

    from ditsep_tpu_torch.sdes import MixSDE, pc_sample
    from ditsep_tpu_torch.serving import StreamingSeparator
    from ditsep_tpu_torch.utils.device import card_line, resolve_device

    dev = resolve_device(device)
    chunk, overlap = int(CHUNK_S * FS), int(OVERLAP_S * FS)
    model = flagship_model(nf, dtype, dev)
    sde = MixSDE(N=n_steps)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    window_s, nfes = [], []

    def sep_fn(mix, lengths=None, generator=None):
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            est, nfe = pc_sample(sde, lambda x, t, y: model(x, t, y), mix,
                                 N=n_steps, snr=0.5, corrector="ald2",
                                 corrector_steps=1, denoise=True,
                                 generator=generator)
            est = est.float()
        sync()
        window_s.append(time.perf_counter() - t0)
        nfes.append(int(nfe))
        return est

    # warm up (excluded from the timing)
    sep_fn(torch.zeros((1, 1, chunk), device=dev),
           generator=torch.Generator(device=dev).manual_seed(0))
    warmup_nfe = nfes.pop()
    window_s.clear()

    rng = np.random.default_rng(0)
    t_total = int(stream_s * FS)
    mix = (rng.standard_normal(t_total) * 0.1).astype(np.float32)
    block = int(BLOCK_S * FS)
    sep = StreamingSeparator(sep_fn, chunk_samples=chunk,
                             overlap_samples=overlap, n_src=2, seed=1,
                             device=dev)
    emitted = 0
    t0 = time.perf_counter()
    for s in range(0, t_total, block):
        emitted += sep.push(mix[s:s + block]).shape[-1]
    emitted += sep.flush().shape[-1]
    wall = time.perf_counter() - t0
    assert emitted == t_total
    card = card_line() if dev.type == "cuda" else "the CPU"
    result = {
        "stream_seconds": stream_s,
        "chunk_seconds": CHUNK_S,
        "overlap_seconds": OVERLAP_S,
        "block_seconds": BLOCK_S,
        "n_windows": len(window_s),
        "sampler_s_per_window": float(np.mean(window_s)),
        "wall_s": wall,
        "realtime_factor": t_total / FS / wall,
        "latency_budget_s": sep.latency_samples / FS,
        "note": f"score model nf={nf} {dtype}, NFE-{2 * n_steps} PC sampler "
                f"(N={n_steps}, ald2, one corrector step) on {card}; "
                "realtime_factor = audio seconds separated per wall second "
                "through the streaming path; wall - n_windows * "
                "sampler_s_per_window is the host's stitching and the "
                "stems' copies to the host",
    }
    return result, {"warmup": warmup_nfe, "windows": nfes}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stream-seconds", type=float,
                   default=float(os.environ.get("STREAM_BENCH_SECONDS",
                                                120)))
    p.add_argument("--nf", type=int, default=128,
                   help="the score model's width (128: the flagship)")
    p.add_argument("--sampler-N", type=int, default=30)
    p.add_argument("--f32", action="store_true",
                   help="float32 compute (default bf16)")
    p.add_argument("--out", default=None,
                   help="also write the JSON result to this file")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    result, _ = run(args.stream_seconds, nf=args.nf, n_steps=args.sampler_N,
                    dtype="f32" if args.f32 else "bf16",
                    device="cpu" if args.cpu else "cuda")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
