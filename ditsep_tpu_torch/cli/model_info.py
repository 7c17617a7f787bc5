"""Model inspection: print the parameter inventory of any configured model
(port of ditsep_tpu/cli/model_info.py; reference: scripts/vae_print.py,
scripts/facodec_print.py, scripts/debug.py, scripts/load_vae_stable.py,
which instantiate a model and print its module tree).

Every model is built on ``torch.device("meta")``, as the JAX package's
uses ``jax.eval_shape``: no parameter memory is allocated and no FLOPs
run, so inspecting the flagship nf=128 model is instant and needs no
card. The inventory groups the parameters by their flax paths
(``models.weights.jax_param_shapes``), so its lines are the JAX
package's.

Usage:
    python -m ditsep_tpu_torch.cli.model_info --config diffsep
    python -m ditsep_tpu_torch.cli.model_info --config latent_diffsep_ouve \
        --latent
    python -m ditsep_tpu_torch.cli.model_info --model-config path/to/model.json
    python -m ditsep_tpu_torch.cli.model_info --facodec
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Tuple

import numpy as np

Shapes = Dict[str, Tuple[int, ...]]


def summarize_params(shapes: Shapes, depth: int = 1):
    """Group ``{path: shape}`` by the first ``depth`` path segments;
    returns (the groups' counts, the total), the groups in the order of
    a flax tree's leaves (each level's names sorted)."""
    groups: Dict[str, int] = {}
    total = 0
    for path in sorted(shapes, key=lambda p: p.split("/")):
        shape = shapes[path]
        n = int(np.prod(shape)) if shape else 1
        total += n
        key = "/".join(path.split("/")[:depth])
        groups[key] = groups.get(key, 0) + n
    return groups, total


def print_inventory(name: str, shapes: Shapes, depth: int):
    groups, total = summarize_params(shapes, depth)
    print(f"\n{name}: {total:,} parameters")
    width = max((len(k) for k in groups), default=0)
    for k, n in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<{width}}  {n:>12,}  ({100 * n / total:5.1f}%)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None,
                   help="experiment family (diffsep / diffsep_ouve / "
                        "diffsep_sb / latent_diffsep_ouve / ldm)")
    p.add_argument("--model-config", default=None,
                   help="stable-audio JSON model config path")
    p.add_argument("--facodec", action="store_true",
                   help="inventory the FACodec encoder/decoder")
    p.add_argument("--latent", action="store_true")
    p.add_argument("--override", nargs="*", default=[])
    p.add_argument("--depth", type=int, default=2,
                   help="module-path depth for grouping")
    args = p.parse_args(argv)

    import torch

    from ditsep_tpu_torch.models.weights import jax_param_shapes

    meta = torch.device("meta")

    if args.facodec:
        from ditsep_tpu_torch.models.facodec import (
            FACodecDecoder, FACodecEncoder,
        )
        with meta:
            enc, dec = FACodecEncoder(), FACodecDecoder()
        print_inventory("FACodecEncoder", jax_param_shapes(enc), args.depth)
        print_inventory("FACodecDecoder", jax_param_shapes(dec), args.depth)
        return

    if args.model_config:
        from ditsep_tpu_torch.models.factory import create_model_from_config
        with open(args.model_config) as f:
            cfg = json.load(f)
        with meta:
            obj = create_model_from_config(cfg)
        mtype = cfg["model_type"]
        if mtype == "autoencoder":
            print_inventory(type(obj).__name__, jax_param_shapes(obj),
                            args.depth)
        elif mtype == "lm":
            lm, pattern = obj
            print(f"pattern: {type(pattern).__name__}")
            print_inventory("AudioLM", jax_param_shapes(lm), args.depth)
        else:
            print(f"model_type={mtype}: {obj!r}")
        return

    if not args.config:
        p.error("one of --config / --model-config / --facodec is required")

    from ditsep_tpu_torch.cli.common import load_config
    from ditsep_tpu_torch.configs.build import (
        _dtype, _VAE_KEYS, build_sde,
    )
    from ditsep_tpu_torch.models.oobleck import OobleckVAE
    from ditsep_tpu_torch.models.score_models import (
        LatentScoreModelNCSNpp, ScoreModelNCSNpp,
    )

    cfg = load_config(args.config, args.override)
    m = cfg["model"]
    sm = dict(m["score_model"])
    kind = sm.pop("kind")
    sm["dtype"] = _dtype(sm.get("dtype"))
    if args.latent or args.config.startswith("latent"):
        vae_cfg = {k: v for k, v in m["vae"].items() if k in _VAE_KEYS}
        vae_cfg["dtype"] = _dtype(vae_cfg.get("dtype"))
        with meta:
            vae = OobleckVAE(**vae_cfg)
            model = LatentScoreModelNCSNpp(**sm)
        print_inventory("OobleckVAE", jax_param_shapes(vae), args.depth)
        print_inventory("LatentScoreModelNCSNpp", jax_param_shapes(model),
                        args.depth)
    else:
        if kind != "ScoreModelNCSNpp":
            raise SystemExit(f"config {args.config!r} is a latent one: "
                             "pass --latent")
        with meta:
            model = ScoreModelNCSNpp(**sm)
        print_inventory(type(model).__name__, jax_param_shapes(model),
                        args.depth)
    print(f"\nsde: {build_sde(m['sde'])}")


if __name__ == "__main__":
    main()
