"""Export a training checkpoint to bare inference weights (the port of
ditsep_tpu/cli/unwrap_model.py; reference: src/training/unwrap_model.py).

    python -m ditsep_tpu_torch.cli.unwrap_model --ckpt-dir RUN/checkpoints \\
        --out weights.npz [--no-ema] [--which best|latest]

Reads a ``CheckpointManager`` directory (``best-model`` or ``latest``,
each holding ``state.pt``), takes the score model's EMA weights (or with
``--no-ema`` the trained ones) of a TrainState, as ``cli.train_diffsep``
and ``cli.train_diffsep_latent`` save it, and writes them as the flat
``.npz`` that both packages' CLIs take with ``--params``. The decoder
finetune's and the VAE-GAN's states hold no score model, and the JAX
package's tool reads none of them: they are refused.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ditsep_tpu_torch.models.weights import save_params_npz
from ditsep_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager


def main(argv=None) -> str:
    """Returns the path of the state it read."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint directory (CheckpointManager layout)")
    p.add_argument("--out", required=True, help="output .npz path")
    p.add_argument("--use-ema", action="store_true", default=True)
    p.add_argument("--no-ema", dest="use_ema", action="store_false")
    p.add_argument("--which", default="best", choices=["best", "latest"])
    args = p.parse_args(argv)

    mgr = CheckpointManager(args.ckpt_dir, write=False)
    path = mgr.best_path() if args.which == "best" else mgr.latest_path()
    if path is None:
        raise SystemExit(f"no checkpoints in {args.ckpt_dir}")
    state = torch.load(Path(path) / STATE_FILE, map_location="cpu")
    if "model" not in state:
        kind = ("the LDM decoder finetune's" if "decoder" in state
                else "the VAE-GAN's" if "vae" in state else "this")
        raise SystemExit(
            f"{path}: {kind} state holds no score model; unwrap_model "
            "exports a TrainState's (cli.train_diffsep, cli."
            "train_diffsep_latent), as the JAX package's tool does")
    key = "ema" if args.use_ema and "ema" in state else "model"
    save_params_npz(args.out, state[key])
    print(f"wrote {args.out} from {path} ({key})")
    return path


if __name__ == "__main__":
    main()
