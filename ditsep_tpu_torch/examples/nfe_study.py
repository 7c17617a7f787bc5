"""Sampler study with a sign-off rule: quality against NFE (port of
examples/nfe_study.py). Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.examples.nfe_study --params ema.npz \\
        [--out study.json] [--configs pc_N30 pc_N15 ...] [--cpu]

Loads the EMA that ``train_synthetic --save-params`` writes (the JAX
package's flat .npz, through ``load_params_npz``) into the same model and
separates the 8 held-out synthetic items of 4 s with each configuration:
PC (reverse diffusion + ald2, NFE 2N; the reference protocol at N=30) and
the AB2 multistep sampler (NFE N) at N = 30, 15, 8, each under
``--n-seeds`` sampling seeds (generators seeded 100 + s). A
configuration's mean SI-SDR carries a 95% Student-t interval over the
seeds; its deficit against ``pc_N30`` is paired by seed, and it is
ACCEPTED when the deficit's upper 95% bound is at most
``--accept-delta-db``. ``--configs`` runs a subset (``pc_N30``, the
baseline, always among them). Prints one JSON line a configuration, then
the study with the keys of docs/nfe_study.json; writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ditsep_tpu_torch.configs import build_diffsep_trainer
from ditsep_tpu_torch.examples.train_synthetic import (
    mean_si_sdr, synthetic_config, test_batch,
)
from ditsep_tpu_torch.utils.device import card_line, resolve_device

# two-sided 97.5% Student-t quantiles for small sample sizes (df 1..30)
_T975 = [12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
         2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
         2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
         2.048, 2.045, 2.042]

# name -> (sampler, N); pc_N30 (NFE 60) is the reference protocol
CONFIGS: Dict[str, Tuple[str, int]] = {
    "pc_N30": ("pc", 30), "pc_N15": ("pc", 15), "pc_N8": ("pc", 8),
    "ab2_N30": ("ab2", 30), "ab2_N15": ("ab2", 15), "ab2_N8": ("ab2", 8)}
BASELINE = "pc_N30"
SEED0 = 100


def _mean_ci(vals) -> Tuple[float, float]:
    """(mean, 95% CI half-width) by the Student-t interval."""
    v = np.asarray(vals, np.float64)
    n = len(v)
    if n < 2:
        return float(v.mean()), float("nan")
    t = _T975[min(n - 1, len(_T975)) - 1]
    return float(v.mean()), float(t * v.std(ddof=1) / math.sqrt(n))


def summarize(per_seed: Dict[str, Sequence[float]], nfe: Dict[str, int],
              accept_delta_db: float) -> Dict[str, dict]:
    """Each configuration's entry of the study: its mean and CI, its
    per-seed values, its seed-paired deficit against pc_N30 with the CI,
    the upper bound and the verdict (all rounded to 3 decimals)."""
    base = np.asarray(per_seed[BASELINE])
    results = {}
    for name, vals in per_seed.items():
        mean, ci = _mean_ci(vals)
        d_mean, d_ci = _mean_ci(base - np.asarray(vals))
        upper = d_mean + (0.0 if math.isnan(d_ci) else d_ci)
        results[name] = {
            "nfe": nfe[name],
            "si_sdr_mean": round(mean, 3),
            "si_sdr_ci95": round(ci, 3),
            "si_sdr_per_seed": [round(v, 3) for v in vals],
            "deficit_vs_pc_N30_mean": round(d_mean, 3),
            "deficit_vs_pc_N30_ci95": round(d_ci, 3),
            "deficit_upper95": round(upper, 3),
            "accepted": bool(upper <= accept_delta_db),
        }
    return results


def main(argv=None) -> Dict:
    """Run the study; returns it (the last line printed)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--params", required=True)
    p.add_argument("--nf", type=int, default=32)
    p.add_argument("--len-s", type=float, default=4.0)
    p.add_argument("--n-items", type=int, default=8)
    p.add_argument("--n-seeds", type=int, default=5)
    p.add_argument("--accept-delta-db", type=float, default=0.5,
                   help="max tolerated mean SI-SDR deficit vs PC@30 "
                        "(upper 95%% confidence bound)")
    p.add_argument("--configs", nargs="+", default=list(CONFIGS),
                   choices=list(CONFIGS),
                   help="the configurations to run (pc_N30 among them)")
    p.add_argument("--out", default=None, help="JSON artifact path")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if BASELINE not in args.configs:
        raise ValueError(f"--configs needs the baseline {BASELINE}")
    device = resolve_device("cpu" if args.cpu else "cuda")
    trainer = build_diffsep_trainer(synthetic_config(args.nf),
                                    device=device, params_npz=args.params)
    mix_t, tgt_t = test_batch(args.n_items, args.len_s, device)

    per_seed: Dict[str, List[float]] = {}
    nfe: Dict[str, int] = {}
    for name in args.configs:
        sampler, n = CONFIGS[name]
        vals = []
        for s in range(args.n_seeds):
            est, nfe[name] = trainer.separate(
                mix_t, N=n, sampler=sampler,
                generator=torch.Generator(device).manual_seed(SEED0 + s))
            vals.append(mean_si_sdr(est, tgt_t))
        per_seed[name] = vals
        mean, ci = _mean_ci(vals)
        print(json.dumps({name: {"nfe": nfe[name],
                                 "si_sdr_mean": round(mean, 3),
                                 "si_sdr_ci95": round(ci, 3)}}), flush=True)

    study = {
        "protocol": {
            "n_seeds": args.n_seeds,
            "n_items": args.n_items,
            "len_s": args.len_s,
            "accept_rule": ("accepted iff upper 95% CI bound of the "
                            "seed-paired SI-SDR deficit vs pc_N30 <= "
                            f"{args.accept_delta_db} dB"),
            "model_nf": args.nf,
            "data": "SyntheticMixDataset (band-split synthetic mixtures; "
                    "real-data sign-off requires WSJ0/LibriMix)",
            "card": card_line() if device.type == "cuda" else "cpu",
        },
        "mixture_baseline_si_sdr": round(
            mean_si_sdr(mix_t.expand_as(tgt_t), tgt_t), 3),
        "configs": summarize(per_seed, nfe, args.accept_delta_db),
    }
    print(json.dumps(study), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(study, f, indent=2)
    return study


if __name__ == "__main__":
    main()
