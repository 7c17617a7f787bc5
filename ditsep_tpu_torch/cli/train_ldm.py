"""The LDM decoder finetune (the port's ditsep_tpu/cli/train_ldm.py;
reference: src/train_ldm.py:27-173): finetune the OobleckVAE's decoder on
a latent cache (``cli.cache_latents``' separated latents and their clean
targets) by PIT-MRSTFT, and with ``--use-disc`` against the Encodec
discriminator. Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.cli.train_ldm --latent-cache CACHE \\
        --workdir DIR [--vae-params VAE.npz] [--use-disc] [--resume] \\
        [--batch-size 4] [--max-steps N] [--demo-every N] [--cpu] \\
        [--override a.b=v]

Each epoch visits the cache in the order of ``np.random.default_rng(seed
+ epoch)``, in batches cropped to their shortest item; odd steps are
discriminator steps once it is warmed up (``LDMTrainer.
use_disc_this_step``). Every 10 steps the last step's metrics go to
DIR/metrics.jsonl under the JAX package's keys (and, with tensorboardX
installed, to DIR/tb/); each epoch ends with a checkpoint in
DIR/checkpoints, the 5 of lowest ``train/loss`` kept. With --demo-every N
the cache's first item is decoded through the live decoder every N steps
and logged as audio (``demo/est_{s}/0`` beside ``demo/target_{s}/0``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ditsep_tpu_torch.cli.common import (
    add_common_args, load_config, make_dataset,
)
from ditsep_tpu_torch.configs import build_latent_trainer
from ditsep_tpu_torch.data import LatentDataset
from ditsep_tpu_torch.models.discriminators import (
    MultiScaleSTFTDiscriminator,
)
from ditsep_tpu_torch.training.demo import _log_wavs
from ditsep_tpu_torch.training.ldm import LDMLossWeights, LDMTrainer
from ditsep_tpu_torch.utils.checkpoint import CheckpointManager
from ditsep_tpu_torch.utils.device import resolve_device
from ditsep_tpu_torch.utils.logging import MetricsLogger


def build_ldm_trainer(cfg, latent_trainer, disc_channels=None, seed=0
                      ) -> LDMTrainer:
    """The LDM trainer of ``cfg``'s ``training`` block around
    ``latent_trainer``; with ``disc_channels`` (the waveform channels the
    losses see: n_src) the Encodec discriminator, seeded weights drawn on
    the CPU, on the latent trainer's device."""
    tcfg = cfg["training"]
    disc = None
    if disc_channels is not None:
        dc = tcfg["loss"]["discriminator"]
        disc = MultiScaleSTFTDiscriminator(
            filters=dc["filters"], in_channels=disc_channels,
            n_ffts=tuple(dc["n_ffts"]), hop_lengths=tuple(dc["hop_lengths"]))
        disc.reset_parameters(torch.Generator().manual_seed(seed))
        disc.to(next(latent_trainer.vae.parameters()).device)
    sp = tcfg["loss"]["spectral"]
    return LDMTrainer(
        latent_trainer=latent_trainer, disc=disc,
        weights=LDMLossWeights(
            mrstft=sp["weights"]["mrstft"],
            l1=tcfg["loss"]["time"]["weights"].get("l1", 0.0),
            fft_sizes=tuple(sp["fft_sizes"]),
            hop_sizes=tuple(sp["hop_sizes"]),
            perceptual_weighting=sp["perceptual_weighting"],
            sample_rate=cfg["datamodule"].get("fs", 8000)),
        lr=tcfg["lr"], clip_grad_norm=tcfg["clip_grad_norm"],
        warmup_steps=tcfg["warmup_steps"], warmup_mode=tcfg["warmup_mode"])


def main(argv=None):
    """Returns the final LDMState."""
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.set_defaults(config="ldm")
    p.add_argument("--vae-params", default=None,
                   help="npz with the OobleckVAE's parameters (the JAX "
                        "package's export)")
    p.add_argument("--latent-cache", required=True,
                   help="latent cache dir (see cli.cache_latents)")
    p.add_argument("--use-disc", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="resume from the workdir's newest checkpoint "
                        "(fresh start if none exists)")
    p.add_argument("--demo-every", type=int, default=0,
                   help="log demo decodes (est/target wavs through the "
                        "live decoder) every N steps")
    args = p.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: this CLI trains on one device, as the JAX package's "
            "does (it parses --mesh and ignores it); the LDM and VAE-GAN "
            "trainers run data-parallel through the API, gen_step / "
            "disc_step(..., mesh=) (scripts/dryrun_multichip.py legs 3-4)")
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.config, args.override)
    latent_trainer = build_latent_trainer(cfg, device=device, seed=args.seed,
                                          vae_params_npz=args.vae_params)
    base_ds = make_dataset(cfg, "train", args.data_path, args.synthetic,
                           synthetic_items=args.synthetic_items,
                           synthetic_len_s=args.synthetic_len_s)
    ds = LatentDataset(args.latent_cache, base_ds)
    batch_size = args.batch_size or 4
    if len(ds) < batch_size:
        raise SystemExit(f"the cache holds {len(ds)} latents, fewer than "
                         f"one batch of {batch_size}")
    # the losses see (B, n_src, T) stacks: the discriminator takes n_src
    # waveform channels
    ldm = build_ldm_trainer(cfg, latent_trainer,
                            ds[0][0].shape[0] if args.use_disc else None,
                            seed=args.seed)
    state = ldm.init_state()
    logger = MetricsLogger(args.workdir)
    ckpt = CheckpointManager(f"{args.workdir}/checkpoints",
                             monitor="train/loss", mode="min", save_top_k=5)
    if args.resume:
        try:
            state = ckpt.restore(state, prefer="latest")
            print(f"[train_ldm] resumed at step {state.step}")
        except FileNotFoundError:
            pass

    fs = cfg["datamodule"].get("fs", 8000)
    demo_tgt, demo_lat = ds[0]
    demo_tgt = demo_tgt[None]
    demo_lat = torch.from_numpy(demo_lat[None]).to(device)

    def log_demo(step, decoded):
        for s in range(decoded.shape[1]):
            _log_wavs(logger, f"demo/est_{s}", decoded[:, s:s + 1], step,
                      fs, 2)
            _log_wavs(logger, f"demo/target_{s}", demo_tgt[:, s:s + 1], step,
                      fs, 2)

    step = state.step
    max_steps = args.max_steps or 10000
    epoch = 0
    while step < max_steps:
        order = np.random.default_rng(args.seed + epoch).permutation(len(ds))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [ds[int(i)] for i in order[start:start + batch_size]]
            t_min = min(t.shape[-1] for t, _ in items)
            l_min = min(lat.shape[-1] for _, lat in items)
            reals = torch.from_numpy(np.stack(
                [t[..., :t_min] for t, _ in items])).to(device)
            latents = torch.from_numpy(np.stack(
                [lat[..., :l_min] for _, lat in items])).to(device)
            if ldm.use_disc_this_step(step):
                state, metrics = ldm.disc_step(state, latents, reals)
            else:
                state, metrics = ldm.gen_step(
                    state, latents, reals,
                    warmed_up=step >= ldm.warmup_steps)
            step += 1
            if step % 10 == 0:
                logger.log({k: v.item() for k, v in metrics.items()}, step)
            if args.demo_every and step % args.demo_every == 0:
                with torch.no_grad():
                    decoded = latent_trainer.decode(demo_lat,
                                                    demo_tgt.shape[-1])
                logger.guarded("train_ldm: demo", step, log_demo, step,
                               decoded)
            if step >= max_steps:
                break
        epoch += 1
        loss = metrics.get("train/loss")
        ckpt.save(state, step, {"train/loss": np.inf if loss is None
                                else loss.item()})
    logger.close()
    state.media_failures = logger.failures
    print(f"finished {step} steps; checkpoints in {args.workdir}")
    return state


if __name__ == "__main__":
    main()
