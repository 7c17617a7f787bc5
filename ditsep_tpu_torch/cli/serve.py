"""Demo web server CLI (port of ditsep_tpu/cli/serve.py): the separation
demo, and with ``--vae-config`` the autoencoder tab, over the
dependency-free stdlib HTTP UI in ``ditsep_tpu_torch.interface.web``.
Runs on the CUDA card unless --cpu is given.

    python -m ditsep_tpu_torch.cli.serve --config diffsep \\
        [--params X.npz] [--vae-config vae.json [--vae-params V.npz]] \\
        [--port 7860] [--gradio] [--cpu]

``--gradio`` launches the gradio widget shell (``interface.gradio_ui``)
over the same backends instead; without the gradio package it raises
ImportError.
"""
from __future__ import annotations

import argparse
import json

from ditsep_tpu_torch.cli.common import add_common_args, load_config
from ditsep_tpu_torch.configs import build_diffsep_trainer
from ditsep_tpu_torch.interface import (
    AutoencoderApp, DemoServer, SeparationApp,
)
from ditsep_tpu_torch.utils.device import resolve_device


def build_separation_app(cfg, params_npz=None, *, device="cuda",
                         seed: int = 0) -> SeparationApp:
    """The separation backend: the config's trainer on ``device`` with
    seeded weights or the JAX package's ``.npz`` export."""
    trainer = build_diffsep_trainer(cfg, device=device, seed=seed,
                                    params_npz=params_npz)
    return SeparationApp(trainer=trainer,
                         fs=cfg["datamodule"].get("fs", 8000))


def build_autoencoder_app(vae_config, vae_params=None, *, device="cuda",
                          seed: int = 0) -> AutoencoderApp:
    """The autoencoder backend: the stable-audio JSON autoencoder config
    through the model factory, seeded weights or the JAX package's VAE
    ``.npz`` (``vae_params``), on ``device``."""
    import torch

    from ditsep_tpu_torch.models.factory import create_model_from_config
    from ditsep_tpu_torch.models.weights import load_params_npz

    with open(vae_config) as f:
        mc = json.load(f)
    dev = resolve_device(device)
    vae = create_model_from_config(
        mc, generator=torch.Generator().manual_seed(seed))
    if vae_params:
        load_params_npz(vae_params, vae)
    return AutoencoderApp(vae=vae.to(dev).eval(),
                          fs=int(mc.get("sample_rate", 8000)))


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]))
    p.add_argument("--params", default=None,
                   help="npz score-model params exported by ditsep_tpu")
    p.add_argument("--vae-config", default=None,
                   help="stable-audio JSON autoencoder config: adds the "
                        "autoencoder tab")
    p.add_argument("--vae-params", default=None,
                   help="npz VAE params exported by ditsep_tpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--gradio", action="store_true",
                   help="launch the gradio widget shell instead of the "
                        "stdlib UI (needs the gradio package)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg = load_config(args.config, args.override)
    separation = build_separation_app(cfg, args.params, device=device,
                                      seed=args.seed)
    autoencoder = (build_autoencoder_app(args.vae_config, args.vae_params,
                                         device=device, seed=args.seed)
                   if args.vae_config else None)
    if args.gradio:
        from ditsep_tpu_torch.interface import create_ui
        create_ui(separation=separation, autoencoder=autoencoder,
                  fs=separation.fs).launch(server_name=args.host,
                                           server_port=args.port)
        return
    DemoServer(separation=separation, autoencoder=autoencoder,
               host=args.host, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
