"""Experiment config families of the port, copied from
ditsep_tpu/configs/__init__.py: ``diffsep`` and ``diffsep_icassp``
(MixSDE), ``diffsep_ouve`` (OUVESDE), ``diffsep_sb`` (SBVESDE with EDM
preconditioning) and ``enhancement`` (PriorMixSDE at 16 kHz on
VCTK-DEMAND), ``latent_diffsep_ouve`` (OUVESDE in the OobleckVAE's latent
space), ``ldm`` (the decoder finetune on that model's latents); and
``override`` for dotted-path overrides."""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from ditsep_tpu_torch.configs.build import (  # noqa: F401
    build_diffsep_trainer, build_latent_trainer, build_oobleck_vae,
)


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


def diffsep_ouve() -> Dict[str, Any]:
    """Scalar OUVE SDE family."""
    cfg = diffsep()
    cfg["name"] = "diffsep_ouve"
    cfg["model"]["sde"] = {"kind": "ouve", "theta": 1.5, "sigma_min": 0.05,
                           "sigma_max": 0.5, "N": 30}
    return cfg


def diffsep_sb() -> Dict[str, Any]:
    """Schroedinger-bridge SBVE family with EDM preconditioning; the
    reference sets init_hack_p 0 'to solve the autograd nan problem'."""
    cfg = diffsep()
    cfg["name"] = "diffsep_sb"
    cfg["model"]["sde"] = {"kind": "sbve", "k": 2.6, "c": 0.4, "eps": 1e-8,
                           "N": 30, "sampler_type": "ode"}
    cfg["model"]["init_hack_p"] = 0.0
    cfg["model"]["sampler"] = {"N": 30, "snr": 0.5, "corrector_steps": 1}
    cfg["model"]["network_scaling"] = "1/sigma"
    cfg["model"]["c"] = "edm"
    cfg["model"]["sigma_data"] = 0.1
    return cfg


def enhancement() -> Dict[str, Any]:
    """Speech enhancement on VCTK-DEMAND as 2-source (clean + noise)
    separation with the signal-adaptive PriorMixSDE, 16 kHz, init hack 4,
    3 s training crops."""
    cfg = override(diffsep(), {
        "model.fs": 16000,
        "model.init_hack": 4,
        "model.train_source_order": None,
        "model.valid_max_sep_batches": 1,
        "model.score_model.nf": 128,
        "model.sde": {"kind": "priormix", "ndim": 2, "d_lambda": 2.0,
                      "sigma_min": 0.05, "sigma_max": 0.5, "N": 30},
        "datamodule.dataset": "vctk_demand",
        "datamodule.fs": 16000,
        "datamodule.max_len_s": 3.0,
        "datamodule.train.batch_size": 4,
        "datamodule.val.batch_size": 8,
        "datamodule.test.batch_size": 8,
        "trainer.accumulate_grad_batches": 4,
    })
    cfg["name"] = "enhancement"
    return cfg


def latent_diffsep_ouve() -> Dict[str, Any]:
    """Latent-domain separation: the latent NCSN++ with OUVESDE (theta 1.5,
    sigma in [0.96, 10]) on the frozen oobleck_finetune VAE (hop 2048,
    64 latent channels, 8 kHz)."""
    return {
        "name": "latent_diffsep_ouve",
        "model": {
            **_TRAIN_COMMON,
            "train_source_order": "pit",
            "score_model": {
                "kind": "LatentScoreModelNCSNpp",
                "num_sources": 2,
                "nf": 128,
                "ch_mult": (1, 2, 2),
                "num_res_blocks": 2,
                "attn_resolutions": (16,),
                "resamp_with_conv": True,
                "image_size": 64,
                "centered": True,
                "max_latent_length": 4,
            },
            "vae": dict(_OOBLECK_FINETUNE),
            "sde": {"kind": "ouve", "theta": 1.5, "sigma_min": 0.96,
                    "sigma_max": 10.0, "N": 30},
            "sampler": {"N": 30, "snr": 0.5, "corrector_steps": 1},
        },
        "datamodule": _datamodule_default(),
        "trainer": {"accumulate_grad_batches": 4, "precision": "bf16"},
    }


_OOBLECK_FINETUNE = {
    # the reference's oobleck_finetune.json autoencoder
    "in_channels": 1,
    "out_channels": 1,
    "channels": 128,
    "latent_dim": 64,
    "c_mults": (1, 2, 4, 8, 16),
    "strides": (2, 4, 4, 8, 8),
    "sample_rate": 8000,
    "sample_size": 247808,
}


def ldm() -> Dict[str, Any]:
    """The decoder finetune (reference: src/config/ldm/): the
    latent_diffsep_ouve model, AdamW at 1.5e-4 with the global-norm clip
    1.0, the perceptual 7-resolution MRSTFT and, off by default, the
    Encodec discriminator (filters 64, n_ffts 2048 ... 128)."""
    base = latent_diffsep_ouve()
    return {
        "name": "ldm",
        "model": base["model"],
        "training": {
            "lr": 1.5e-4,
            "clip_grad_norm": 1.0,
            "use_ema": True,
            "warmup_steps": 0,
            "warmup_mode": "full",
            "loss": {
                "spectral": {
                    "weights": {"mrstft": 1.0},
                    "decay": 1.0,
                    "fft_sizes": (2048, 1024, 512, 256, 128, 64, 32),
                    "hop_sizes": (512, 256, 128, 64, 32, 16, 8),
                    "perceptual_weighting": True,
                },
                "time": {"weights": {"l1": 0.0}},
                "discriminator": {
                    "enabled": False,
                    "filters": 64,
                    "n_ffts": (2048, 1024, 512, 256, 128),
                    "hop_lengths": (512, 256, 128, 64, 32),
                    "weights": {"adversarial": 0.1,
                                "feature_matching": 5.0},
                },
            },
        },
        "datamodule": base["datamodule"],
    }


CONFIG_FAMILIES = {
    "diffsep": diffsep,
    "diffsep_icassp": diffsep_icassp,
    "diffsep_ouve": diffsep_ouve,
    "diffsep_sb": diffsep_sb,
    "enhancement": enhancement,
    "latent_diffsep_ouve": latent_diffsep_ouve,
    "ldm": ldm,
}
