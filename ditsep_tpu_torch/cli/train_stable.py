"""Train a stable-audio JSON model config (the port's ditsep_tpu/cli/
train_stable.py; reference: stable-audio-tools' train.py composition of
training/factory.py:5-245): ``create_model_from_config`` ->
``create_trainer_from_config`` -> ``create_demo_callback_from_config``, on
synthetic data. Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.cli.train_stable --model-config CFG.json \\
        [--workdir DIR] [--batch-size 4] [--max-steps 100] \\
        [--sample-size N] [--ckpt-every N] [--demo-every N] [--resume] \\
        [--seed 0] [--cpu]

Model types: 'autoencoder' (the VAE-GAN, generator and discriminator
steps alternating), 'diffusion_uncond' (audio-domain, e.g. the
dance-diffusion DAU1d configs) and 'lm' (token grids). Conditional
diffusion needs text encoders whose weights are not here: it is refused,
as the JAX CLI refuses it. The data is a fixed synthetic batch made from
--seed: tonal audio (random tones of 80-2000 Hz at 8 kHz's time base), or
for 'lm' uniform tokens, sample_size // 2048 frames (at least 8).

Step n draws from a generator seeded by (seed, n), as the JAX CLI's
``fold_in(k_step, n)``, so ``--resume`` from the rolling checkpoint that
``--ckpt-every`` writes repeats the run that was not stopped. Every 10
steps the step's metrics go to DIR/metrics.jsonl (and TensorBoard with
tensorboardX); the run ends with a top-3 checkpoint by ``train/loss`` in
DIR and prints ``{"final": metrics, "steps": N, "media_failures": n}``.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ditsep_tpu_torch.utils.checkpoint import CheckpointManager
from ditsep_tpu_torch.utils.device import resolve_device
from ditsep_tpu_torch.utils.logging import MetricsLogger

TRAINABLE = ("autoencoder", "diffusion_uncond", "lm")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``: a function of (seed, step) only."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step])
                      .generate_state(1)[0]))
    return g


def synthetic_audio(generator: torch.Generator, batch: int, channels: int,
                    length: int) -> torch.Tensor:
    """0.3 sin(2 pi f t + phase) a channel, f in [80, 2000) Hz and the
    phase uniform, t at 8 kHz: deterministic, finite, not degenerate."""
    freqs = 80.0 + 1920.0 * torch.rand((batch, channels, 1),
                                       generator=generator)
    phase = 2 * math.pi * torch.rand((batch, channels, 1),
                                     generator=generator)
    t = torch.arange(length, dtype=torch.float32) / 8000.0
    return 0.3 * torch.sin(2 * math.pi * freqs * t + phase)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-config", required=True,
                   help="path to a stable-audio model JSON config")
    p.add_argument("--workdir", default="./runs/stable")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-steps", type=int, default=100)
    p.add_argument("--sample-size", type=int, default=None,
                   help="override the config's sample_size")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="save the rolling latest checkpoint every N steps "
                        "(0: at the end only)")
    p.add_argument("--demo-every", type=int, default=0,
                   help="override training.demo.demo_every (0: the config's)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the workdir's latest checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from ditsep_tpu_torch.models.factory import create_model_from_config
    from ditsep_tpu_torch.training.demo import (
        create_demo_callback_from_config)
    from ditsep_tpu_torch.training.factory import create_trainer_from_config

    with open(args.model_config) as f:
        cfg = json.load(f)
    cfg.setdefault("training", {"learning_rate": 1e-4})
    if args.sample_size is not None:
        cfg["sample_size"] = args.sample_size
    if args.demo_every:
        cfg["training"].setdefault("demo", {})["demo_every"] = args.demo_every
    model_type = cfg.get("model_type")
    if model_type not in TRAINABLE:
        raise SystemExit(
            f"model_type {model_type!r} is not trainable from this generic "
            "entry (conditional diffusion needs host text encoders); use "
            "the dedicated train_* CLIs")
    sample_size = cfg.get("sample_size", 65536)

    data_gen = torch.Generator().manual_seed(args.seed)
    with torch.device(device):
        init_gen = torch.Generator(device=device).manual_seed(args.seed)
        model = create_model_from_config(cfg, init_gen)
        trainer = create_trainer_from_config(cfg, model, init_gen)
    net = model[0] if isinstance(model, tuple) else model
    demo_kw = ({"pattern": model[1]} if model_type == "lm" else
               {"io_channels": net.io_channels}
               if model_type == "diffusion_uncond" else {})
    demo_cb = create_demo_callback_from_config(cfg, **demo_kw)

    logger = MetricsLogger(args.workdir)
    ckpts = CheckpointManager(args.workdir, monitor="train/loss", mode="min",
                              save_top_k=3)
    if model_type == "autoencoder":
        in_ch = cfg["model"].get("encoder", {}).get("config", {}).get(
            "in_channels", 1)
        batch = synthetic_audio(data_gen, args.batch_size, in_ch,
                                sample_size).to(device)

        def step_fn(state, step, g):
            if trainer.use_disc_this_step(step):
                return trainer.disc_step(state, batch, generator=g)
            return trainer.gen_step(state, batch,
                                    warmed_up=step >= trainer.warmup_steps,
                                    generator=g)

        def demo(state, step):
            demo_cb(logger, step, state.vae, batch)
    elif model_type == "diffusion_uncond":
        batch = synthetic_audio(data_gen, args.batch_size, net.io_channels,
                                sample_size).to(device)

        def step_fn(state, step, g):
            return trainer.train_step(state, batch, generator=g)

        def demo(state, step):
            demo_cb(logger, step, state.ema, generator=step_generator(
                args.seed, 1_000_000 + step, device))
    else:
        lm = trainer.model
        t_tok = max(sample_size // 2048, 8)
        batch = torch.randint(0, lm.codebook_size, (
            args.batch_size, lm.n_quantizers, t_tok),
            generator=data_gen).to(device)

        def step_fn(state, step, g):
            return trainer.train_step(state, batch)

        def demo(state, step):
            demo_cb(logger, step, state.ema, generator=step_generator(
                args.seed, 1_000_000 + step, device), length=t_tok)

    state, start = trainer.init_state(), 0
    if args.resume and ckpts.latest_path() is not None:
        ckpts.restore(state, prefer="latest")
        start = state.step
        print(json.dumps({"resumed_at_step": start}), flush=True)
    m = {}
    for step in range(start, args.max_steps):
        state, m = step_fn(state, step, step_generator(args.seed, step,
                                                       device))
        if step % 10 == 0:
            logger.log({k: float(v) for k, v in m.items()}, step)
        if args.ckpt_every and step and step % args.ckpt_every == 0:
            ckpts.save_latest(state, step)
        if step > 0 and demo_cb.due(step):
            demo(state, step)
    metrics = {k: float(v) for k, v in m.items()}
    ckpts.save(state, args.max_steps, metrics)
    out = {"final": metrics, "steps": args.max_steps,
           "media_failures": logger.failures}
    logger.close()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
