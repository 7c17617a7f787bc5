"""Shared CLI plumbing: config resolution with hydra-style overrides, the
common and training flags, dataset construction and the demo callbacks
(the port's ditsep_tpu/cli/common.py:11-120)."""
from __future__ import annotations

import argparse
import ast
from typing import Dict, Optional

from ditsep_tpu_torch.configs import CONFIG_FAMILIES, override


def parse_overrides(pairs) -> Dict[str, object]:
    """Parse 'a.b.c=value' CLI overrides."""
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def load_config(name: str, overrides=None):
    if name not in CONFIG_FAMILIES:
        raise SystemExit(f"unknown config {name!r}; choose from "
                         f"{sorted(CONFIG_FAMILIES)}")
    return override(CONFIG_FAMILIES[name](), parse_overrides(overrides))


def make_dataset(cfg, split: str, data_path: Optional[str],
                 synthetic: bool = False, synthetic_items: int = 16,
                 synthetic_len_s: Optional[float] = None):
    """The synthetic mixtures (``synthetic`` or no ``data_path``; fixed
    length ``synthetic_len_s`` when given), the enhancement config's
    VCTK-DEMAND split, or the config's WSJ0-mix / LibriMix split under
    ``data_path`` (training items cropped to ``max_len_s``)."""
    dm = cfg["datamodule"]
    if synthetic or data_path is None:
        from ditsep_tpu_torch.data import SyntheticMixDataset
        kw = {}
        if synthetic_len_s is not None:
            kw = {"min_len_s": synthetic_len_s, "max_len_s": synthetic_len_s}
        return SyntheticMixDataset(n_items=synthetic_items,
                                   n_spkr=dm.get("n_spkr", 2),
                                   fs=dm.get("fs", 8000), **kw)
    if dm.get("dataset") == "vctk_demand":
        # enhancement: (noisy, [clean, noise]) pairs, training items tiled
        # or cropped to max_len_s
        from ditsep_tpu_torch.data import NoisyDataset
        return NoisyDataset(
            path=data_path, split=split, fs=dm.get("fs", 16000),
            len_s=dm.get("max_len_s") if split == "train" else None)
    from ditsep_tpu_torch.data import WSJ0Mix
    return WSJ0Mix(path=data_path, n_spkr=dm.get("n_spkr", 2),
                   cut=dm.get("cut", "max"), split=dm[split]["split"],
                   fs=dm.get("fs", 8000),
                   max_len_s=dm.get("max_len_s") if split == "train" else None)


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA card)")
    p.add_argument("--config", default="diffsep")
    p.add_argument("--data-path", default=None,
                   help="dataset root (wsj0-mix / LibriMix layout, or "
                        "VCTK-DEMAND for --config enhancement)")
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (smoke runs)")
    p.add_argument("--synthetic-items", type=int, default=16,
                   help="synthetic dataset size")
    p.add_argument("--synthetic-len-s", type=float, default=None,
                   help="fixed synthetic utterance length in seconds")
    p.add_argument("--workdir", default="./runs/exp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--mesh", action="store_true",
                   help="shard the batch over the devices: the ranks of "
                        "python -m torch.distributed.run (NCCL; gloo with "
                        "--cpu), or serve_api's local cards")
    p.add_argument("--override", nargs="*", default=[],
                   help="config overrides a.b.c=value")
    return p


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--resume", action="store_true",
                   help="resume from the workdir's rolling latest "
                        "checkpoint (fresh start if none exists)")
    p.add_argument("--demo-every", type=int, default=0,
                   help="log demo separations (mix/est/target wavs) "
                        "every N steps (0 = off)")
    return p


def make_demo_callbacks(dataset, demo_every: int, fs: int = 8000,
                        n_items: int = 2) -> tuple:
    """A ``SeparationDemoCallback`` over the first ``n_items`` of
    ``dataset``, for ``training.loop.fit(callbacks=...)``; () when
    ``demo_every`` is 0 or the dataset is empty or None."""
    if not demo_every or dataset is None or len(dataset) == 0:
        return ()
    from ditsep_tpu_torch.data import max_collator
    from ditsep_tpu_torch.training.demo import SeparationDemoCallback

    items = [dataset[i] for i in range(min(n_items, len(dataset)))]
    return (SeparationDemoCallback(demo_batch=max_collator(items),
                                   demo_every=demo_every, sample_rate=fs),)
