"""Latent-domain score training (the port's ditsep_tpu/cli/
train_diffsep_latent.py; reference: src/train_diffsep_latent.py). Runs on
the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.cli.train_diffsep_latent --synthetic \\
        --synthetic-items 32 --synthetic-len-s 5.0 --max-steps 4 \\
        --workdir DIR [--vae-params VAE.npz] [--cpu] [--demo-every N] \\
        [--override a.b=v]

The VAE's weights come from --vae-params (the JAX package's ``.npz``
export, the file its CLI takes); without it they are seeded random
weights (smoke runs only). The VAE stays frozen. Writes what
cli.train_diffsep writes: DIR/metrics.jsonl, DIR/hparams.json,
DIR/checkpoints/ and DIR/ema.npz (the score model's EMA weights in the
JAX package's flat layout). ``--mesh`` under ``python -m
torch.distributed.run --nproc-per-node N`` trains data-parallel, as
cli.train_diffsep does.
"""
from __future__ import annotations

import argparse
import dataclasses

from ditsep_tpu_torch.cli.common import (
    add_common_args, add_train_args, load_config, make_dataset,
    make_demo_callbacks,
)
from ditsep_tpu_torch.configs import build_latent_trainer
from ditsep_tpu_torch.parallel import (
    initialize_multihost, make_mesh, shutdown,
)
from ditsep_tpu_torch.training.loop import fit
from ditsep_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class _VAEBoundTrainer:
    """A LatentDiffSepTrainer behind fit()'s trainer interface: the train
    step, the validation loss, the validation separation and the demo
    callback's ``separate`` take waveform batches and go through the
    trainer's frozen VAE."""

    trainer: object

    @property
    def model(self):
        return self.trainer.model

    @property
    def cfg(self):
        return self.trainer.cfg

    @property
    def sde(self):
        return self.trainer.sde

    def init_state(self):
        return self.trainer.init_state()

    def train_step(self, state, batch, **kw):
        return self.trainer.train_step_latent(state, batch, **kw)

    def val_score_loss(self, model, batch, **kw):
        return self.trainer.val_score_loss_latent(model, batch, **kw)

    def val_separation_metrics(self, model, batch, **kw):
        return self.trainer.val_metrics_latent(model, batch, **kw)

    def separate(self, mix, **kw):
        """encode -> latent PC -> decode, cropped to the mixture's length:
        (estimates (B, n_src, T), nfe)."""
        return self.trainer.separate_latent(mix, target_dim=mix.shape[-1],
                                            **kw)


def main(argv=None):
    """Returns the final TrainState."""
    p = add_train_args(add_common_args(
        argparse.ArgumentParser(description=__doc__.split("\n\n")[0])))
    p.set_defaults(config="latent_diffsep_ouve")
    p.add_argument("--vae-params", default=None,
                   help="npz with the OobleckVAE's parameters (the JAX "
                        "package's export)")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    mesh = None
    if args.mesh:
        initialize_multihost(device=device)
        mesh = make_mesh(device=device)
        device = mesh.device
    cfg = load_config(args.config, args.override)
    trainer = build_latent_trainer(cfg, device=device, seed=args.seed,
                                   vae_params_npz=args.vae_params)
    train_ds = make_dataset(cfg, "train", args.data_path, args.synthetic,
                            synthetic_items=args.synthetic_items,
                            synthetic_len_s=args.synthetic_len_s)
    val_ds = make_dataset(cfg, "val", args.data_path, args.synthetic,
                          synthetic_len_s=args.synthetic_len_s,
                          synthetic_items=4)
    batch_size = args.batch_size or cfg["datamodule"]["train"]["batch_size"]
    fs = cfg["datamodule"].get("fs", 8000)
    return fit(_VAEBoundTrainer(trainer), train_ds, val_ds,
               workdir=args.workdir, max_epochs=args.max_epochs or 1000,
               batch_size=batch_size, seed=args.seed,
               valid_max_sep_batches=cfg["model"].get(
                   "valid_max_sep_batches", 2),
               max_steps=args.max_steps, resume=args.resume, mesh=mesh,
               callbacks=make_demo_callbacks(val_ds, args.demo_every, fs=fs),
               media_fs=fs)


if __name__ == "__main__":
    main()
    shutdown()  # leave the process group of a --mesh run
