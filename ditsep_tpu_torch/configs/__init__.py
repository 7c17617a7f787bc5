"""Experiment config families of the port: the ``diffsep`` and
``diffsep_icassp`` dicts, copied from ditsep_tpu/configs/__init__.py, and
``override`` for dotted-path overrides."""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from ditsep_tpu_torch.configs.build import build_diffsep_trainer  # noqa: F401


def override(cfg: Dict[str, Any], overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """Apply {"dotted.path": value} overrides to a nested config dict."""
    cfg = copy.deepcopy(cfg)
    for path, value in (overrides or {}).items():
        node = cfg
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg


_SCORE_MODEL_WAVEFORM = {
    "kind": "ScoreModelNCSNpp",
    "num_sources": 2,
    "n_fft": 510,
    "hop_length": 128,
    "transform": "exponent",
    "spec_abs_exponent": 0.5,
    "spec_factor": 0.15,
    "nf": 64,
    "ch_mult": (1, 1, 2, 2, 2, 2, 2),
    "num_res_blocks": 2,
    "attn_resolutions": (16,),
    "resamp_with_conv": True,
    "image_size": 256,
    "centered": False,
}

_TRAIN_COMMON = {
    "n_speakers": 2,
    "fs": 8000,
    "t_eps": 0.03,
    "t_rev_init": 0.03,
    "ema_decay": 0.999,
    "valid_max_sep_batches": 2,
    "time_sampling_strategy": "uniform",
    "init_hack": 5,
    "init_hack_p": 0.1,
    "mmnr_thresh_pit": -10.0,
    "lr": 2e-4,
    "grad_clip": 5.0,
}


def _datamodule_default() -> Dict[str, Any]:
    return {
        "dataset": "librimix",
        "n_spkr": 2,
        "fs": 8000,
        "cut": "max",
        "max_len_s": 5.0,
        "train": {"split": "librimix_train-360", "batch_size": 16},
        "val": {"split": "librimix_dev", "batch_size": 16},
        "test": {"split": "librimix_test", "batch_size": 16},
    }


def diffsep() -> Dict[str, Any]:
    """MixSDE STFT-domain separation."""
    return {
        "name": "diffsep",
        "model": {
            **_TRAIN_COMMON,
            "train_source_order": "power",
            "score_model": dict(_SCORE_MODEL_WAVEFORM),
            "sde": {"kind": "mix", "ndim": 2, "d_lambda": 2.0,
                    "sigma_min": 0.05, "sigma_max": 0.5, "N": 30},
            "sampler": {"N": 30, "snr": 0.5, "corrector_steps": 1},
        },
        "datamodule": _datamodule_default(),
        "trainer": {"accumulate_grad_batches": 8, "max_epochs": 1000},
    }


def diffsep_icassp() -> Dict[str, Any]:
    """ICASSP separation experiment: nf=128 (the flagship)."""
    return override(diffsep(), {
        "model.score_model.nf": 128,
        "trainer.accumulate_grad_batches": 2,
        "datamodule.train.batch_size": 6,
        "datamodule.val.batch_size": 5,
        "datamodule.test.batch_size": 5,
    })


CONFIG_FAMILIES = {
    "diffsep": diffsep,
    "diffsep_icassp": diffsep_icassp,
}
