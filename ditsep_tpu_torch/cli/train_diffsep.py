"""Waveform-domain score training (the port's ditsep_tpu/cli/
train_diffsep.py). Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.cli.train_diffsep --config diffsep_icassp \\
        --synthetic --synthetic-items 12 --synthetic-len-s 5.0 \\
        --max-steps 4 --workdir DIR [--cpu] [--resume] [--demo-every N] \\
        [--override a.b=v]

``--config`` is any of diffsep, diffsep_icassp, diffsep_ouve, diffsep_sb
(the EDM loss) and enhancement (PriorMix, init hack 4; VCTK-DEMAND under
--data-path, 3 s crops at 16 kHz).

Writes DIR/metrics.jsonl, DIR/hparams.json, DIR/checkpoints/ (top-k on
val/si_sdr, latest, best-model, index.json) and DIR/ema.npz (the EMA
weights in the JAX package's flat layout, loadable by both packages'
separate CLIs with --params); with tensorboardX installed, DIR/tb/ holds
the scalars, each validation's audio and spectrogram figure and, with
--demo-every N, the demo separations of the first two validation items
every N steps.

Data-parallel over N cards (the global --batch-size split over the ranks,
the gradient averaged before the clip; rank 0 writes; ``--cpu``: N gloo
processes):

    python -m torch.distributed.run --nproc-per-node N \\
        -m ditsep_tpu_torch.cli.train_diffsep --mesh ...
"""
from __future__ import annotations

import argparse

from ditsep_tpu_torch.cli.common import (
    add_common_args, add_train_args, load_config, make_dataset,
    make_demo_callbacks,
)
from ditsep_tpu_torch.configs import build_diffsep_trainer
from ditsep_tpu_torch.parallel import (
    initialize_multihost, make_mesh, shutdown,
)
from ditsep_tpu_torch.training.loop import fit
from ditsep_tpu_torch.utils.device import resolve_device


def main(argv=None):
    """Returns the final TrainState."""
    p = add_train_args(add_common_args(
        argparse.ArgumentParser(description=__doc__.split("\n\n")[0])))
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    mesh = None
    if args.mesh:
        initialize_multihost(device=device)
        mesh = make_mesh(device=device)
        device = mesh.device
    cfg = load_config(args.config, args.override)
    trainer = build_diffsep_trainer(cfg, device=device, seed=args.seed)
    train_ds = make_dataset(cfg, "train", args.data_path, args.synthetic,
                            synthetic_items=args.synthetic_items,
                            synthetic_len_s=args.synthetic_len_s)
    val_ds = make_dataset(cfg, "val", args.data_path, args.synthetic,
                          synthetic_len_s=args.synthetic_len_s,
                          synthetic_items=4)
    batch_size = args.batch_size or cfg["datamodule"]["train"]["batch_size"]
    fs = cfg["datamodule"].get("fs", 8000)
    return fit(trainer, train_ds, val_ds, workdir=args.workdir,
               max_epochs=(args.max_epochs
                           or cfg["trainer"].get("max_epochs", 1000)),
               batch_size=batch_size, seed=args.seed,
               valid_max_sep_batches=cfg["model"].get(
                   "valid_max_sep_batches", 2),
               max_steps=args.max_steps, resume=args.resume, mesh=mesh,
               callbacks=make_demo_callbacks(val_ds, args.demo_every, fs=fs),
               media_fs=fs)


if __name__ == "__main__":
    main()
    shutdown()  # leave the process group of a --mesh run
