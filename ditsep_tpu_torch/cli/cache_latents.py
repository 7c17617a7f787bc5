"""Latent caching (the port's ditsep_tpu/cli/cache_latents.py; reference:
src/ldm.py:296-389): each item's mixture is encoded (a posterior sample),
PC-sampled ``--n-samples-per-item`` times in the latent space, and each
latent estimate stored with the item's targets, in the JAX package's file
format (data/latent_ds.py), for decoder finetuning. Runs on the CUDA card
unless --cpu is given.

    python -m ditsep_tpu_torch.cli.cache_latents --out-dir DIR \\
        [--vae-params VAE.npz] [--score-params SCORE.npz] \\
        [--synthetic | --data-path ROOT] [--sampler-N 30] [--cpu]

``metadata.npz`` is refreshed every 10 items, so an interrupted run
leaves a readable cache.
"""
from __future__ import annotations

import argparse

import torch

from ditsep_tpu_torch.cli.common import (
    add_common_args, load_config, make_dataset,
)
from ditsep_tpu_torch.configs import build_latent_trainer
from ditsep_tpu_torch.data import save_latent_cache, save_latent_metadata
from ditsep_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    """Returns the number of latents cached."""
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.set_defaults(config="latent_diffsep_ouve")
    p.add_argument("--vae-params", default=None)
    p.add_argument("--score-params", default=None,
                   help="npz with the score model's parameters")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-samples-per-item", type=int, default=1)
    p.add_argument("--sampler-N", type=int, default=30)
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.config, args.override)
    trainer = build_latent_trainer(cfg, device=device, seed=args.seed,
                                   params_npz=args.score_params,
                                   vae_params_npz=args.vae_params)
    ds = make_dataset(cfg, "train", args.data_path, args.synthetic,
                      synthetic_items=args.synthetic_items,
                      synthetic_len_s=args.synthetic_len_s)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    k = args.n_samples_per_item
    done, base = [], []
    for i in range(len(ds)):
        # one read: the latent and its stored targets share one crop
        mix, tgt = ds[i]
        mix_t = torch.from_numpy(mix[None]).to(device)
        for s in range(k):
            est, _ = trainer.sample_latents(mix_t, N=args.sampler_N,
                                            generator=generator)
            save_latent_cache(args.out_dir, i * k + s, est[0].cpu().numpy(),
                              targets=tgt)
            done.append(i * k + s)
            base.append(i)
        if i % 10 == 0:
            save_latent_metadata(args.out_dir, done,
                                 extra={"base_indices": base})
    save_latent_metadata(args.out_dir, done, extra={"base_indices": base})
    print(f"cached {len(done)} latents to {args.out_dir}")
    return len(done)


if __name__ == "__main__":
    main()
