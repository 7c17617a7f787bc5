"""Test-set evaluation: bucketed batched sampling, SI-SDR / SI-SIR /
SI-SAR, PESQ and STOI per utterance, the reference schema's results and
summary JSON (port of ditsep_tpu/cli/evaluate.py). Runs on the CUDA card
unless --cpu is given.

    python -m ditsep_tpu_torch.cli.evaluate --config diffsep \\
        [--params X.npz] [--data-path DIR | --synthetic] \\
        [--sampler pc|ab2] [--mask-padding] [--out-dir DIR] [--cpu] \\
        [--save-samples N] [--save-figures N]

Data-parallel over N cards (each rank separates its rows of every batch,
rank 0 scores and writes; ``--cpu``: N gloo processes):

    python -m torch.distributed.run --nproc-per-node N \\
        -m ditsep_tpu_torch.cli.evaluate --mesh ...

``--latent`` evaluates the latent pipeline (``--config
latent_diffsep_ouve``, the VAE's weights from ``--vae-params``): encode,
PC with the ald corrector in the latent space, decode; sample-domain
buckets (``--bucket-multiple``).
"""
from __future__ import annotations

import argparse
import json

from ditsep_tpu_torch.cli.common import (add_common_args, load_config,
                                         make_dataset)
from ditsep_tpu_torch.configs import (
    build_diffsep_trainer, build_latent_trainer,
)
from ditsep_tpu_torch.eval import evaluate_dataset
from ditsep_tpu_torch.parallel import (
    initialize_multihost, make_mesh, shutdown,
)
from ditsep_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    """Returns evaluate_dataset's result: the per-utterance results, the
    summary, the buckets, the separate calls, the metrics' seconds and
    the failed figures."""
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("--params", default=None,
                   help="npz score-model params exported by ditsep_tpu")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--sampler-N", type=int, default=30)
    p.add_argument("--sampler", choices=("pc", "ab2"), default="pc",
                   help="'ab2' = 2nd-order Adams-Bashforth, one score "
                        "evaluation a step; diffsep_sb always takes its "
                        "bridge sampler")
    p.add_argument("--snr", type=float, default=0.5)
    p.add_argument("--corrector-steps", type=int, default=1)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--eval-batch-size", type=int, default=4)
    p.add_argument("--bucket-multiple", type=int, default=4096,
                   help="sample-domain bucket granularity, used only by "
                        "--latent and --no-proc; the waveform model path "
                        "buckets by the score model's 64-frame STFT blocks")
    p.add_argument("--max-buckets", type=int, default=24,
                   help="cap on distinct padded lengths; past it the "
                        "sparsest frame blocks merge upward, padding their "
                        "utterances past their native block (a measured "
                        "quality cost without --mask-padding, "
                        "docs/pad_dilution_r03.md)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the untimed warmup call per bucket")
    p.add_argument("--save-samples", type=int, default=0,
                   help="write enh{i}.wav for the first N utterances")
    p.add_argument("--save-figures", type=int, default=0,
                   help="write a spectrogram PDF for the first N utterances "
                        "(needs matplotlib)")
    p.add_argument("--bf16", action="store_true",
                   help="compute the score network in bfloat16")
    p.add_argument("--mask-padding", action="store_true",
                   help="masked scoring: each utterance's padded tail is "
                        "masked out of the normalization and of every "
                        "GroupNorm and attention statistic (an extension "
                        "beyond the reference, docs/pad_dilution_r03.md)")
    p.add_argument("--no-proc", action="store_true",
                   help="mixture baseline: score the raw mix, no model "
                        "(nfe 0)")
    p.add_argument("--latent", action="store_true",
                   help="the latent pipeline: encode -> latent PC -> decode")
    p.add_argument("--vae-params", default=None,
                   help="npz with the OobleckVAE's parameters (--latent)")
    args = p.parse_args(argv)
    if args.latent and args.sampler != "pc":
        raise SystemExit("--sampler ab2 is not wired for the latent path "
                         "(separate_latent follows the reference 'ald' PC "
                         "config)")
    device = resolve_device("cpu" if args.cpu else "cuda")
    mesh = None
    if args.mesh:
        initialize_multihost(device=device)
        mesh = make_mesh(device=device)
        device = mesh.device
    cfg = load_config(args.config, args.override)
    sm = cfg["model"]["score_model"]
    if args.bf16:
        sm["dtype"] = "bf16"
    if args.mask_padding:
        sm["mask_padding"] = True
    ds = make_dataset(cfg, "test", args.data_path, args.synthetic,
                      synthetic_items=args.synthetic_items,
                      synthetic_len_s=args.synthetic_len_s)
    common = dict(fs=cfg["datamodule"].get("fs", 8000),
                  batch_size=args.eval_batch_size,
                  bucket_multiple=args.bucket_multiple,
                  max_buckets=args.max_buckets, out_dir=args.out_dir,
                  split_name=cfg["datamodule"]["test"]["split"],
                  limit=args.limit, seed=args.seed, device=device,
                  mesh=mesh)

    if args.no_proc:
        # the mixture baseline: the unprocessed mix for every source, nfe 0
        # (reference: evaluate_mp.py:223,303-308, ckpt "__no_proc__")
        n_spkr = ds[0][1].shape[0]

        def sep(mix, lengths=None, generator=None):
            return mix.expand(mix.shape[0], n_spkr, mix.shape[-1])

        res = evaluate_dataset(sep, ds, nfe=0, frame_spec=None,
                               warmup=False, **common)
        print(json.dumps(res["summary"], indent=2))
        return res

    if args.latent:
        trainer = build_latent_trainer(cfg, device=device, seed=args.seed,
                                       params_npz=args.params,
                                       vae_params_npz=args.vae_params)

        def sep(mix, lengths=None, generator=None):
            return trainer.separate_latent(mix, target_dim=mix.shape[-1],
                                           N=args.sampler_N,
                                           generator=generator)[0]
    else:
        trainer = build_diffsep_trainer(cfg, device=device, seed=args.seed,
                                        params_npz=args.params)

        def sep(mix, lengths=None, generator=None):
            return trainer.separate(mix, N=args.sampler_N, snr=args.snr,
                                    corrector_steps=args.corrector_steps,
                                    sampler=args.sampler, lengths=lengths,
                                    generator=generator)[0]

    # the JAX package's count, for every config: N for ab2, else N x
    # (corrector steps + 1), the bridge sampler's N evaluations included
    nfe = (args.sampler_N if args.sampler == "ab2"
           else args.sampler_N * (args.corrector_steps + 1))
    # bucket by the score model's own STFT frame blocks: each utterance
    # keeps the quiet fraction of its native-length evaluation; the latent
    # model pads its frames only to a multiple of max_latent_length (4),
    # so sample-domain buckets serve it
    frame_spec = (None if args.latent else
                  (sm.get("n_fft", 510), sm.get("hop_length", 128), 64))
    res = evaluate_dataset(sep, ds, nfe=nfe, frame_spec=frame_spec,
                           save_samples=args.save_samples,
                           save_figures=args.save_figures,
                           warmup=not args.no_warmup,
                           pass_lengths=args.mask_padding and not args.latent,
                           **common)
    print(json.dumps(res["summary"], indent=2))
    return res


if __name__ == "__main__":
    main()
    shutdown()  # leave the process group of a --mesh run
