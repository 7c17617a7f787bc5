"""FACodec reconstruction demo: encode, quantize, decode WAVs (port of
ditsep_tpu/cli/facodec_demo.py; reference: scripts/facodec_inference.py,
src/models/facodec/inference.py).

For each input WAV: the FACodec encoder (hop 200 at 16 kHz), the
decoder's factorized-VQ groups and timbre conditioning, then
``<name>_reconstructed.wav`` and the codes as ``<name>_codes.npy`` ((T /
hop, 6) int32). The reference downloads trained weights from the HF hub
(amphion/naturalspeech3_facodec); here the weights come from --params, the
``.npz`` the JAX package's demo reads (``enc/...`` and ``dec/...`` flax
paths), or are drawn from ``torch.Generator`` seed 0 (a pipeline check:
the reconstruction is then untrained). Runs on the CUDA card unless --cpu
is given; the last line is a JSON summary with each file's seconds.

    python -m ditsep_tpu_torch.cli.facodec_demo --in-dir wavs/ --out-dir out/
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_codec(device, params: str = None):
    """The shipped FACodec pair (encoder ngf 32, ratios (2, 4, 5, 5), 256
    out; the decoder at the FACodec wrapper's config, facodec.py:629-640:
    upsample_initial_channel 1024) on ``device``, in eval mode, with the
    weights of ``params`` or seeded from 0."""
    import torch

    from ditsep_tpu_torch.models.facodec import (
        FACodecDecoder, FACodecEncoder,
    )
    from ditsep_tpu_torch.models.weights import load_state, params_from_jax

    enc = FACodecEncoder(ngf=32, up_ratios=(2, 4, 5, 5), out_channels=256)
    dec = FACodecDecoder(in_channels=256, ngf=32, up_ratios=(5, 5, 4, 2),
                         upsample_initial_channel=1024)
    if params:
        with np.load(params) as data:
            trees = {"enc": {}, "dec": {}}
            for key in data.files:
                side, _, rest = key.partition("/")
                if side not in trees:
                    raise KeyError(f"{params}: {key!r} is under neither "
                                   "enc/ nor dec/")
                trees[side][rest] = data[key]
        for model, side in ((enc, "enc"), (dec, "dec")):
            load_state(model, params_from_jax(trees[side], model),
                       source=f"{params} ({side}/)")
    else:
        g = torch.Generator().manual_seed(0)
        enc.reset_parameters(g)
        dec.reset_parameters(g)
    return enc.to(device).eval(), dec.to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--in-dir", required=True, help="directory of .wav")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--params", default=None,
                   help="npz of trained params (random init otherwise)")
    p.add_argument("--fs", type=int, default=16000,
                   help="FACodec operating rate (reference: 16 kHz)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the card)")
    args = p.parse_args(argv)

    import torch

    from ditsep_tpu_torch.data import read_wav, write_wav
    from ditsep_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    enc, dec = build_codec(device, args.params)
    hop = enc.hop_length

    os.makedirs(args.out_dir, exist_ok=True)
    wavs = sorted(f for f in os.listdir(args.in_dir) if f.endswith(".wav"))
    if not wavs:
        raise SystemExit(f"no .wav files in {args.in_dir}")
    file_s = []
    for name in wavs:
        audio, fs = read_wav(os.path.join(args.in_dir, name))
        if fs != args.fs:
            from ditsep_tpu_torch.data.webdataset import _resample
            audio = _resample(np.atleast_2d(audio), fs, args.fs)
        audio = np.atleast_2d(audio)[:1]  # mono
        t = audio.shape[-1]
        t0 = time.perf_counter()
        x = torch.from_numpy(np.pad(audio, ((0, 0), (0, (-t) % hop)))[None]
                             .astype(np.float32)).to(device)  # (1, 1, T)
        with torch.no_grad():
            rec, info = dec(enc(x), return_info=True)
        rec = rec[0, 0, :t].cpu().numpy()
        codes = info["indices"][0].cpu().numpy().astype(np.int32)
        vq_loss = float(info["vq_loss"])
        file_s.append(time.perf_counter() - t0)
        stem = os.path.splitext(name)[0]
        write_wav(os.path.join(args.out_dir, f"{stem}_reconstructed.wav"),
                  rec, args.fs)
        np.save(os.path.join(args.out_dir, f"{stem}_codes.npy"), codes)
        print(f"{name}: {t} samples -> codes "
              f"{tuple(info['indices'].shape[1:])}, vq_loss "
              f"{vq_loss:.4f}")
    print(json.dumps({"files": len(file_s), "device": str(device),
                      "params": sum(p.numel() for m in (enc, dec)
                                    for p in m.parameters()),
                      "hop": hop, "file_s": file_s}), flush=True)


if __name__ == "__main__":
    main()
