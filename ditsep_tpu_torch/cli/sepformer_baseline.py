"""SepFormer baseline separation for comparison runs (port of
ditsep_tpu/cli/sepformer_baseline.py; reference: scripts/sepformer.py:1-20):
separate a folder of mixtures with a SepFormer and write ``s0/``, ``s1/``
... in the layout of ``cli.separate``, so the two systems' outputs diff
directly. Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.cli.sepformer_baseline \\
        --input mixtures/ --output baseline_out/ [--ckpt sepformer_ckpt/] \\
        [--model-kwargs '{"enc_channels": 64}'] [--bucket 8192] [--cpu]

Two backends:

* ``--backend native`` (default): ``models.SepFormer``. ``--ckpt`` is one
  merged torch state file, or a directory with SpeechBrain's
  ``encoder.ckpt`` / ``masknet.ckpt`` / ``decoder.ckpt`` (the savedir of
  ``Sepformer.from_hparams``), loaded through
  ``sepformer_params_from_torch``; without it the weights are random,
  drawn from seed 0 (smoke runs only), and the CLI says so. Each file
  is zero-padded to a multiple of ``--bucket`` samples, as the JAX CLI
  pads it: the pad is seen by attention, so the outputs depend on it.
  Each written source is peak-normalized, as SpeechBrain's
  ``separate_file`` writes it.
* ``--backend speechbrain``: the pretrained SpeechBrain model, gated on
  the ``speechbrain`` package.

The native backend prints a JSON line at the end: the files, the
parameter count and each file's seconds (to the card's synchronization).
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _load_native_state(path: str):
    """SpeechBrain's per-module checkpoint files merged into one flat dict
    with ``encoder.`` / ``masknet.`` / ``decoder.`` prefixes, or a merged
    state file as it is."""
    import torch

    if os.path.isdir(path):
        state = {}
        for mod in ("encoder", "masknet", "decoder"):
            f = os.path.join(path, f"{mod}.ckpt")
            if not os.path.exists(f):
                raise SystemExit(
                    f"--ckpt dir {path} is missing {mod}.ckpt (expected "
                    "the SpeechBrain savedir layout)")
            sd = torch.load(f, map_location="cpu", weights_only=True)
            state.update({f"{mod}.{k}": v for k, v in sd.items()})
        return state
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj.get("state_dict", obj) if isinstance(obj, dict) else obj


def _run_native(args, wavs):
    import numpy as np
    import torch

    from ditsep_tpu_torch.data import read_wav, write_wav
    from ditsep_tpu_torch.models.sepformer import (
        SepFormer, sepformer_params_from_torch)
    from ditsep_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    kwargs = json.loads(args.model_kwargs) if args.model_kwargs else {}
    kwargs.setdefault("num_spks", args.num_spks)
    model = SepFormer(**kwargs)
    if args.ckpt:
        model.load_state_dict(sepformer_params_from_torch(
            _load_native_state(args.ckpt), model))
    else:
        print("[sepformer_baseline] no --ckpt: RANDOM weights from seed 0 "
              "(smoke run)", flush=True)
        model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    file_s = []
    for name in wavs:
        x, fs = read_wav(os.path.join(args.input, name))
        if fs != args.fs:
            print(f"[sepformer_baseline] {name}: {fs} Hz != --fs "
                  f"{args.fs}, skipping")
            continue
        T = x.shape[-1]
        t0 = time.perf_counter()
        mix = np.pad(x.astype(np.float32), (0, (-T) % args.bucket))[None]
        with torch.no_grad():
            est = model(torch.from_numpy(mix).to(device))
        est = est[0, :, :T].cpu().numpy()  # (spks, T): synchronizes
        file_s.append(time.perf_counter() - t0)
        est = est / np.maximum(np.abs(est).max(axis=-1, keepdims=True),
                               1e-8)
        for s in range(est.shape[0]):
            out_dir = os.path.join(args.output, f"s{s}")
            os.makedirs(out_dir, exist_ok=True)
            write_wav(os.path.join(out_dir, name), est[s], args.fs)
    print(f"separated {len(file_s)} files -> {args.output}/s*/ (native)")
    print(json.dumps({"files": len(file_s), "device": str(device),
                      "params": sum(p.numel() for p in model.parameters()),
                      "bucket": args.bucket, "file_s": file_s}), flush=True)


def _run_speechbrain(args, wavs):
    try:
        from speechbrain.inference.separation import (
            SepformerSeparation as Sepformer)
    except ImportError as e:
        raise SystemExit(
            "speechbrain is not installed; use --backend native, or "
            "install speechbrain in a baseline-eval environment") from e

    import numpy as np

    from ditsep_tpu_torch.data import write_wav

    model = Sepformer.from_hparams(source=args.model, savedir=args.savedir)
    for name in wavs:
        est = model.separate_file(path=os.path.join(args.input, name))
        est = est.detach().cpu().numpy()  # (1, T, n_src)
        for s in range(est.shape[-1]):
            out_dir = os.path.join(args.output, f"s{s}")
            os.makedirs(out_dir, exist_ok=True)
            write_wav(os.path.join(out_dir, name),
                      np.asarray(est[0, :, s]), args.fs)
    print(f"separated {len(wavs)} files -> {args.output}/s*/ (speechbrain)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True, help="folder of mixture wavs")
    p.add_argument("--output", required=True)
    p.add_argument("--backend", choices=("native", "speechbrain"),
                   default="native")
    p.add_argument("--ckpt", default=None,
                   help="(native) SpeechBrain checkpoint: merged state "
                        "file or savedir with encoder/masknet/decoder.ckpt")
    p.add_argument("--num-spks", type=int, default=2)
    p.add_argument("--model-kwargs", default=None,
                   help="(native) JSON dict of SepFormer overrides, e.g. "
                        '\'{"enc_channels": 64}\'; default = published '
                        "sepformer-wsj02mix hyperparameters")
    p.add_argument("--fs", type=int, default=8000)
    p.add_argument("--bucket", type=int, default=8192,
                   help="(native) pad lengths to this multiple")
    p.add_argument("--cpu", action="store_true",
                   help="(native) run on the CPU (the default is the card)")
    p.add_argument("--model", default="speechbrain/sepformer-wsj02mix",
                   help="(speechbrain) HF hub id")
    p.add_argument("--savedir", default="./sepformer_ckpt")
    args = p.parse_args(argv)

    wavs = sorted(f for f in os.listdir(args.input)
                  if f.lower().endswith(".wav"))
    if args.backend == "native":
        _run_native(args, wavs)
    else:
        _run_speechbrain(args, wavs)


if __name__ == "__main__":
    main()
