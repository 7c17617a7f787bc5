"""Separation API server: dynamic batching over the port's samplers
(``ditsep_tpu_torch.serving``; port of ditsep_tpu/cli/serve_api.py). Runs
on the CUDA card unless --cpu is given.

Unlike ``cli/serve.py`` (the interactive demo, one sampler call per
request), this serves a machine-facing JSON/WAV API where CONCURRENT
requests are batched into single sampler calls on the card.

    python -m ditsep_tpu_torch.cli.serve_api --config diffsep_icassp \\
        [--params X.npz] [--mask-padding] [--port 8000] [--max-batch 8] \\
        [--warmup-seconds 4 8] [--bf16] [--cpu] [--mesh]
    python -m ditsep_tpu_torch.cli.serve_api --latent \\
        --config latent_diffsep_ouve [--params X.npz] [--vae-params V.npz]
"""
from __future__ import annotations

import argparse
import copy
import dataclasses

import torch

from ditsep_tpu_torch.cli.common import add_common_args, load_config
from ditsep_tpu_torch.configs import (
    build_diffsep_trainer, build_latent_trainer,
)
from ditsep_tpu_torch.parallel import initialize_multihost, make_mesh
from ditsep_tpu_torch.serving import BatchingEngine, SeparationAPIServer


class TrainerSeparator:
    """The engine's ``separate_fn`` over a trainer: ``trainer.separate``
    (waveform) or ``trainer.separate_latent`` cropped to the input length
    (latent). ``nfe`` is its last call's score evaluations."""

    def __init__(self, trainer, *, latent: bool, N: int, sampler: str):
        self.trainer, self.latent = trainer, latent
        self.N, self.sampler = N, sampler
        self.nfe = 0

    def replicate(self, device) -> "TrainerSeparator":
        """A copy whose trainer's modules (the score model, the VAE) live
        on ``device``: the engine's replica on another card."""
        fields = {f.name: getattr(self.trainer, f.name)
                  for f in dataclasses.fields(self.trainer)}
        moved = {k: copy.deepcopy(v).to(device) for k, v in fields.items()
                 if isinstance(v, torch.nn.Module)}
        return TrainerSeparator(dataclasses.replace(self.trainer, **moved),
                                latent=self.latent, N=self.N,
                                sampler=self.sampler)

    def __call__(self, mix, lengths=None, generator=None):
        if self.latent:
            est, self.nfe = self.trainer.separate_latent(
                mix, target_dim=mix.shape[-1], N=self.N,
                sampler=self.sampler, generator=generator)
        else:
            est, self.nfe = self.trainer.separate(
                mix, N=self.N, sampler=self.sampler, lengths=lengths,
                generator=generator)
        return est


def build_engine(cfg, *, device="cuda", params_npz=None, max_batch=8,
                 max_wait_ms=50.0, sampler_N=30, sampler="pc",
                 mask_padding=False, max_seconds=60.0, latent=False,
                 vae_params_npz=None, seed=0, wire_int16=False,
                 pipeline_depth=2, mesh=None) -> BatchingEngine:
    """A BatchingEngine around the config's separation call on ``device``
    (with ``mesh``, its first card, and a replica on each other card).

    ``latent=True`` serves the latent pipeline (VAE encode -> latent PC
    sampling -> VAE decode) with sample-domain buckets of 16 VAE hops; the
    default serves the waveform pipeline with frame-block buckets, passing
    each request's length under ``mask_padding``. The weights are seeded
    by ``seed`` or loaded from the JAX package's ``.npz`` exports
    (``params_npz``, ``vae_params_npz``); ``seed`` also seeds the engine's
    generator. The engine's ``separate_fn`` is a ``TrainerSeparator``."""
    if mask_padding:
        cfg["model"]["score_model"]["mask_padding"] = True
    fs = cfg["datamodule"].get("fs", 8000)
    if mesh is not None:
        device = mesh.device
    common = dict(fs=fs, max_batch=max_batch, max_wait_ms=max_wait_ms,
                  max_seconds=max_seconds, seed=seed, wire_int16=wire_int16,
                  pipeline_depth=pipeline_depth, device=device, mesh=mesh)

    if latent:
        trainer = build_latent_trainer(cfg, device=device, seed=seed,
                                       params_npz=params_npz,
                                       vae_params_npz=vae_params_npz)
        fn = TrainerSeparator(trainer, latent=True, N=sampler_N,
                              sampler=sampler)
        # the latent model pads its frames to a multiple of 4 only, so
        # sample-domain buckets of 16 VAE hops serve it
        return BatchingEngine(
            fn, frame_spec=None,
            bucket_multiple=trainer.vae.downsampling_ratio * 16, **common)

    trainer = build_diffsep_trainer(cfg, device=device, seed=seed,
                                    params_npz=params_npz)
    sm = cfg["model"]["score_model"]
    frame_spec = (sm.get("n_fft", 510), sm.get("hop_length", 128), 64)
    fn = TrainerSeparator(trainer, latent=False, N=sampler_N,
                          sampler=sampler)
    return BatchingEngine(fn, frame_spec=frame_spec,
                          pass_lengths=mask_padding, **common)


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("--params", default=None,
                   help="npz score-model params exported by ditsep_tpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--max-seconds", type=float, default=60.0,
                   help="reject utterances longer than this")
    p.add_argument("--sampler-N", type=int, default=30)
    p.add_argument("--sampler", choices=("pc", "ab2"), default="pc",
                   help="'ab2' = 2nd-order Adams-Bashforth, one score "
                        "evaluation a step, on the waveform or --latent "
                        "path")
    p.add_argument("--bf16", action="store_true",
                   help="compute the score network in bfloat16")
    p.add_argument("--mask-padding", action="store_true",
                   help="masked scoring: each request's padding is masked "
                        "out of the normalization and of the GroupNorm "
                        "and attention statistics "
                        "(docs/pad_dilution_r03.md)")
    p.add_argument("--latent", action="store_true",
                   help="serve the latent pipeline (VAE encode -> latent "
                        "PC sampling -> decode); use with --config "
                        "latent_diffsep_ouve and --vae-params")
    p.add_argument("--vae-params", default=None,
                   help="npz with OobleckVAE params (latent mode)")
    p.add_argument("--wire-int16", action="store_true",
                   help="move audio host <-> device as int16 (WAV-16 "
                        "resolution, the API's own output width): half "
                        "the transfer bytes")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="batches in flight: >= 2 copies a batch's "
                        "estimates to the host on a completion thread "
                        "while the next batch runs; 1 = upload, separate "
                        "and download in turn")
    p.add_argument("--stream-chunk-seconds", type=float, default=8.0,
                   help="default window for /v1/stream sessions")
    p.add_argument("--stream-overlap-seconds", type=float, default=1.0,
                   help="default overlap for /v1/stream sessions")
    p.add_argument("--warmup-seconds", type=float, nargs="*", default=(),
                   help="run every batch size at these utterance lengths "
                        "before accepting traffic")
    args = p.parse_args(argv)
    cfg = load_config(args.config, args.override)
    if args.bf16:
        cfg["model"]["score_model"]["dtype"] = "bf16"
    device = "cpu" if args.cpu else "cuda"
    mesh = None
    if args.mesh:
        initialize_multihost(device=device)
        mesh = make_mesh(device=device)

    engine = build_engine(
        cfg, device=device, params_npz=args.params, mesh=mesh,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        sampler_N=args.sampler_N, sampler=args.sampler,
        mask_padding=args.mask_padding, max_seconds=args.max_seconds,
        latent=args.latent, vae_params_npz=args.vae_params, seed=args.seed,
        wire_int16=args.wire_int16, pipeline_depth=args.pipeline_depth)
    fs = engine.fs
    if args.warmup_seconds:
        print(f"[serve_api] warming up {len(args.warmup_seconds)} "
              f"length(s)...")
        engine.warmup([int(s * fs) for s in args.warmup_seconds])

    server = SeparationAPIServer(
        engine, host=args.host, port=args.port,
        n_src=cfg["model"].get("n_speakers", 2),
        stream_chunk_seconds=args.stream_chunk_seconds,
        stream_overlap_seconds=args.stream_overlap_seconds,
    )
    install_graceful_shutdown(server, engine)
    server.serve_forever()


def install_graceful_shutdown(server, engine):
    """SIGTERM/SIGINT drain: stop accepting connections, let the engine
    finish its pending batches, then exit, so that an orchestrator's stop
    (or Ctrl-C) never drops in-flight separations. The close runs on a
    helper thread because ``HTTPServer.shutdown`` must not be called from
    the thread running ``serve_forever`` (the signal handler runs on
    it)."""
    import signal
    import threading

    def drain():
        print("[serve_api] draining: closing listener, finishing "
              "pending batches...")
        server.close()
        # _take_batch dispatches whatever is pending once closed; allow
        # several full sampler calls before giving up the join
        engine.close(timeout=120.0)
        print("[serve_api] drained, exiting")

    def handler(signum, frame):
        threading.Thread(target=drain, daemon=False,
                         name="ditsep-drain").start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, handler)


if __name__ == "__main__":
    main()
