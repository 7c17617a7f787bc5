"""Folder-to-folder separation: read every wav in --input, run the config's
sampler (PC, the Schroedinger-bridge sampler for diffsep_sb, or --sampler
ab2), write s0/ s1/ ... subfolders with the separated sources, scaled by
mix projection. Runs on the CUDA card unless --cpu is given. With
--chunk-seconds a file is separated in windows of that length, aligned and
crossfaded (``inference.separate_longform``); with --streaming-block-seconds
as well, each file is pushed in blocks of that length through the
bounded-latency ``serving.StreamingSeparator`` instead.

    python -m ditsep_tpu_torch.cli.separate --config diffsep_icassp \\
        --input DIR --output DIR [--params X.npz] [--sampler-N 30] \\
        [--sampler pc|ab2] [--seed 0] [--cpu] [--bf16] [--mask-padding] \\
        [--chunk-seconds S [--overlap-seconds 1.0]
         [--streaming-block-seconds B]] [--override a.b=v ...]

``--config`` is any of diffsep, diffsep_icassp, diffsep_ouve, diffsep_sb
and enhancement (16 kHz).
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from ditsep_tpu_torch.cli.common import load_config
from ditsep_tpu_torch.configs import build_diffsep_trainer
from ditsep_tpu_torch.data import read_wav, write_wav
from ditsep_tpu_torch.inference import separate_longform
from ditsep_tpu_torch.serving import StreamingSeparator
from ditsep_tpu_torch.utils.device import resolve_device


def scale_output(mix: np.ndarray, est: np.ndarray) -> np.ndarray:
    """Project the mixture onto each estimate for output scaling."""
    num = (est * mix).sum(axis=-1, keepdims=True)
    den = np.maximum((est * est).sum(axis=-1, keepdims=True), 1e-10)
    return est * num / den


def main(argv=None) -> int:
    """Returns the score-network evaluations (NFE) spent per file, or per
    window with --chunk-seconds."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="diffsep")
    p.add_argument("--input", required=True, help="folder of wav files")
    p.add_argument("--output", required=True, help="output folder")
    p.add_argument("--params", default=None,
                   help="npz score-model params exported by ditsep_tpu")
    p.add_argument("--sampler-N", type=int, default=30)
    p.add_argument("--sampler", choices=("pc", "ab2"), default="pc",
                   help="'ab2' = 2nd-order Adams-Bashforth, one score "
                        "evaluation a step (NFE N); diffsep_sb always "
                        "takes its bridge sampler")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the random weights and the sampler noise")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--bf16", action="store_true",
                   help="compute the score network in bfloat16")
    p.add_argument("--mask-padding", action="store_true",
                   help="masked scoring: the %%64 frame pad (and a short "
                        "file's padded window) is masked out of the "
                        "normalization and the GroupNorm and attention "
                        "statistics (docs/pad_dilution_r03.md)")
    p.add_argument("--chunk-seconds", type=float, default=None,
                   help="long-form mode: separate in windows of this many "
                        "seconds, permutation-align adjacent windows and "
                        "crossfade them (inference/longform.py)")
    p.add_argument("--overlap-seconds", type=float, default=1.0,
                   help="window overlap for --chunk-seconds (alignment "
                        "and crossfade region)")
    p.add_argument("--streaming-block-seconds", type=float, default=None,
                   help="with --chunk-seconds: feed each file through the "
                        "bounded-latency StreamingSeparator in blocks of "
                        "this many seconds (the real-time path, "
                        "serving/streaming.py) instead of the offline "
                        "stitcher")
    p.add_argument("--override", nargs="*", default=[],
                   help="config overrides a.b.c=value")
    args = p.parse_args(argv)
    if args.streaming_block_seconds and not args.chunk_seconds:
        p.error("--streaming-block-seconds requires --chunk-seconds "
                "(the streaming path is windowed)")
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.config, args.override)
    if args.bf16:
        cfg["model"]["score_model"]["dtype"] = "bf16"
    if args.mask_padding:
        cfg["model"]["score_model"]["mask_padding"] = True

    trainer = build_diffsep_trainer(cfg, device=device, seed=args.seed,
                                    params_npz=args.params)
    n_src = trainer.cfg.n_speakers
    fs = cfg["datamodule"].get("fs", 8000)
    files = sorted(f for f in os.listdir(args.input) if f.endswith(".wav"))
    if not files:
        raise SystemExit(f"no wav files in {args.input}")
    for i in range(n_src):
        Path(args.output, f"s{i}").mkdir(parents=True, exist_ok=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    nfe = 0

    def sep(mix, lengths=None, generator=None):
        nonlocal nfe
        est, nfe = trainer.separate(mix, N=args.sampler_N,
                                    sampler=args.sampler, lengths=lengths,
                                    generator=generator)
        return est

    for f in files:
        mix, _ = read_wav(os.path.join(args.input, f))
        mix = np.atleast_2d(mix).reshape(1, 1, -1).astype(np.float32)
        if args.chunk_seconds and args.streaming_block_seconds:
            stream = StreamingSeparator(
                sep, chunk_samples=int(args.chunk_seconds * fs),
                overlap_samples=int(args.overlap_seconds * fs),
                n_src=n_src, generator=generator,
                pass_lengths=args.mask_padding, device=device)
            block = max(1, int(args.streaming_block_seconds * fs))
            flat = mix.reshape(-1)
            pieces = [stream.push(flat[s:s + block])
                      for s in range(0, flat.shape[-1], block)]
            pieces.append(stream.flush())
            est = np.concatenate(pieces, axis=-1)
        elif args.chunk_seconds:
            est = separate_longform(
                sep, mix.reshape(-1),
                chunk_samples=int(args.chunk_seconds * fs),
                overlap_samples=int(args.overlap_seconds * fs),
                n_src=n_src, generator=generator,
                pass_lengths=args.mask_padding, device=device)
        else:
            est = sep(torch.from_numpy(mix).to(device),
                      generator=generator)[0].float().cpu().numpy()
        est = scale_output(mix[0], est)
        for i in range(n_src):
            write_wav(str(Path(args.output, f"s{i}", f)), est[i], fs)
    print(f"separated {len(files)} files into {args.output}/s0..s{n_src-1} "
          f"(nfe {nfe} per {'window' if args.chunk_seconds else 'file'})")
    return nfe


if __name__ == "__main__":
    main()
