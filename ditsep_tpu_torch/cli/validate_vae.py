"""Sweep a directory of OobleckVAE checkpoints and score each one's
reconstructions (the port's ditsep_tpu/cli/validate_vae.py; reference:
src/training/validate_stable.py:20-133). Runs on the CUDA card unless
--cpu is given.

    python -m ditsep_tpu_torch.cli.validate_vae --params-dir DIR \\
        [--config latent_diffsep_ouve] [--n-items 8] [--synthetic | \\
        --data-path ROOT] [--cpu] [--override a.b=v]

Every ``DIR/*.npz`` (the JAX package's flat VAE layout, as
``models/weights.py:save_params_npz`` writes it) encodes the validation
mixtures, cropped to a multiple of the VAE's hop, to the posterior's mode
and decodes them. One JSON line a file, ``{"ckpt", "si_sdr", "mrstft"}``
(the means over the items of the PIT SI-SDR, clamped at 30 dB, and of the
MRSTFT at 512 / 256), then ``{"best": the row of the highest SI-SDR}``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ditsep_tpu_torch.cli.common import (
    add_common_args, load_config, make_dataset,
)
from ditsep_tpu_torch.configs import build_oobleck_vae
from ditsep_tpu_torch.training.auraloss import multi_resolution_stft_loss
from ditsep_tpu_torch.training.losses import si_sdr_pit
from ditsep_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def score_vae(vae, ds, n_items: int, device) -> Tuple[float, float]:
    """(mean SI-SDR dB, mean MRSTFT) of the round trips of ``ds``'s first
    ``n_items`` mixtures."""
    si_vals, stft_vals = [], []
    hop = vae.downsampling_ratio
    for i in range(min(n_items, len(ds))):
        mix, _ = ds[i]
        t = mix.shape[-1] - mix.shape[-1] % hop
        audio = torch.from_numpy(mix[None, :, :t]).to(device)
        rec = vae.decode(vae.encode(audio))
        si_vals.append(si_sdr_pit(rec, audio, clamp_db=30.0).mean().item())
        stft_vals.append(multi_resolution_stft_loss(
            rec, audio, fft_sizes=(512, 256), hop_sizes=(128, 64)).item())
    return float(np.mean(si_vals)), float(np.mean(stft_vals))


def main(argv=None):
    """Returns the rows, their metrics unrounded."""
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.set_defaults(config="latent_diffsep_ouve")
    p.add_argument("--params-dir", required=True,
                   help="directory of VAE params .npz files to sweep")
    p.add_argument("--n-items", type=int, default=8)
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.config, args.override)
    ds = make_dataset(cfg, "val", args.data_path, args.synthetic,
                      synthetic_items=args.n_items)
    files = sorted(Path(args.params_dir).glob("*.npz"))
    if not files:
        raise SystemExit(f"no .npz params under {args.params_dir}")
    rows, printed = [], []
    for f in files:
        vae = build_oobleck_vae(cfg["model"]["vae"], device=device,
                                params_npz=str(f))
        si, mr = score_vae(vae, ds, args.n_items, device)
        rows.append({"ckpt": f.name, "si_sdr": si, "mrstft": mr})
        printed.append({"ckpt": f.name, "si_sdr": round(si, 3),
                        "mrstft": round(mr, 4)})
        print(json.dumps(printed[-1]))
    print(json.dumps({"best": max(printed, key=lambda r: r["si_sdr"])}))
    return rows


if __name__ == "__main__":
    main()
