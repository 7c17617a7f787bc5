"""Demo web server CLI (port of ditsep_tpu/cli/serve.py): the separation
demo over the dependency-free stdlib HTTP UI in
``ditsep_tpu_torch.interface.web``. Runs on the CUDA card unless --cpu is
given.

    python -m ditsep_tpu_torch.cli.serve --config diffsep \\
        [--params X.npz] [--port 7860] [--cpu]

The autoencoder tab (``--vae-config``) and the gradio shell (``--gradio``)
are not ported yet (ROADMAP A16) and raise.
"""
from __future__ import annotations

import argparse

from ditsep_tpu_torch.cli.common import add_common_args, load_config
from ditsep_tpu_torch.configs import build_diffsep_trainer
from ditsep_tpu_torch.interface import DemoServer, SeparationApp


def build_separation_app(cfg, params_npz=None, *, device="cuda",
                         seed: int = 0) -> SeparationApp:
    """The separation backend: the config's trainer on ``device`` with
    seeded weights or the JAX package's ``.npz`` export."""
    trainer = build_diffsep_trainer(cfg, device=device, seed=seed,
                                    params_npz=params_npz)
    return SeparationApp(trainer=trainer,
                         fs=cfg["datamodule"].get("fs", 8000))


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("--params", default=None,
                   help="npz score-model params exported by ditsep_tpu")
    p.add_argument("--vae-config", default=None,
                   help="autoencoder tab (not ported yet, ROADMAP A16)")
    p.add_argument("--vae-params", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--gradio", action="store_true",
                   help="the gradio widget shell (not ported yet, ROADMAP "
                        "A16)")
    args = p.parse_args(argv)
    if args.vae_config:
        raise NotImplementedError(
            "--vae-config is not ported yet (ROADMAP A16: the autoencoder "
            "backend needs models/factory.py)")
    if args.gradio:
        raise NotImplementedError(
            "--gradio is not ported yet (ROADMAP A16, interface/"
            "gradio_ui.py)")
    cfg = load_config(args.config, args.override)
    separation = build_separation_app(
        cfg, args.params, device="cpu" if args.cpu else "cuda",
        seed=args.seed)
    DemoServer(separation=separation, host=args.host,
               port=args.port).serve_forever()


if __name__ == "__main__":
    main()
