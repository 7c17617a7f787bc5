"""Config -> object builders (port of ditsep_tpu/configs/build.py)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn as nn

from ditsep_tpu_torch.models import (
    LatentScoreModelNCSNpp, OobleckVAE, ScoreModelNCSNpp, load_params_npz,
)
from ditsep_tpu_torch.sdes import SDERegistry
from ditsep_tpu_torch.training.diffsep import DiffSepConfig, DiffSepTrainer
from ditsep_tpu_torch.training.diffsep_latent import LatentDiffSepTrainer
from ditsep_tpu_torch.utils.device import resolve_device

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": None, "float32": None, None: None}


def build_sde(cfg: Dict[str, Any]):
    cfg = dict(cfg)
    kind = cfg.pop("kind")
    if kind in ("ouve", "sbve"):
        cfg.pop("ndim", None)
    return SDERegistry.get_by_name(kind)(**cfg)


def build_score_model(cfg: Dict[str, Any], *,
                      device: Union[str, torch.device, None] = "cuda",
                      seed: int = 0) -> nn.Module:
    """The score model (ScoreModelNCSNpp or LatentScoreModelNCSNpp) in eval
    mode on ``device``, its parameters drawn on the CPU from a generator
    seeded with ``seed`` (so every device gets the same weights).
    ``dtype`` ('bf16' / 'f32') is the compute dtype."""
    device = resolve_device(device)
    cfg = dict(cfg)
    kind = cfg.pop("kind")
    models = {"ScoreModelNCSNpp": ScoreModelNCSNpp,
              "LatentScoreModelNCSNpp": LatentScoreModelNCSNpp}
    if kind not in models:
        raise ValueError(f"unknown score model {kind!r}")
    cfg["dtype"] = _dtype(cfg.get("dtype"))
    model = models[kind](**cfg)
    model.backbone.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _dtype(dt):
    """A config's dtype: a string ('bf16' / 'bfloat16' / 'f32' /
    'float32', as overrides give it), None, or a torch dtype."""
    return dt if isinstance(dt, torch.dtype) else _DTYPES[dt]


_VAE_KEYS = ("in_channels", "out_channels", "channels", "latent_dim",
             "c_mults", "strides", "use_snake", "soft_clip", "dtype")


def build_oobleck_vae(cfg: Dict[str, Any], *,
                      device: Union[str, torch.device, None] = "cuda",
                      seed: int = 0,
                      params_npz: Optional[str] = None) -> OobleckVAE:
    """The frozen OobleckVAE of a ``model.vae`` config (its other keys,
    such as ``sample_rate``, are not the module's) in eval mode on
    ``device``: seeded weights drawn on the CPU, or the JAX package's
    ``.npz`` export. ``dtype`` as the score model's."""
    device = resolve_device(device)
    keep = {k: v for k, v in cfg.items() if k in _VAE_KEYS}
    keep["dtype"] = _dtype(keep.get("dtype"))
    vae = OobleckVAE(**keep)
    vae.reset_parameters(torch.Generator().manual_seed(seed))
    if params_npz:
        load_params_npz(params_npz, vae)
    return vae.to(device).eval().requires_grad_(False)


def _diffsep_cfg(model_cfg: Dict[str, Any]) -> DiffSepConfig:
    m = model_cfg
    return DiffSepConfig(
        n_speakers=m.get("n_speakers", 2),
        t_eps=m.get("t_eps", 0.03),
        t_rev_init=m.get("t_rev_init", 0.03),
        ema_decay=m.get("ema_decay", 0.999),
        time_sampling_strategy=m.get("time_sampling_strategy", "uniform"),
        train_source_order=m.get("train_source_order", "power"),
        init_hack=m.get("init_hack", 5),
        init_hack_p=m.get("init_hack_p", 0.1),
        mmnr_thresh_pit=m.get("mmnr_thresh_pit", -10.0),
        lr=m.get("lr", 2e-4),
        lr_warmup=m.get("lr_warmup"),
        grad_clip=m.get("grad_clip", 5.0),
        sampler_N=m.get("sampler", {}).get("N", 30),
        sampler_snr=m.get("sampler", {}).get("snr", 0.5),
        sampler_corrector_steps=m.get("sampler", {}).get(
            "corrector_steps", 1),
        network_scaling=m.get("network_scaling", "1/sigma"),
        c=m.get("c", "edm"),
        sigma_data=m.get("sigma_data", 0.1),
    )


def build_diffsep_trainer(cfg: Dict[str, Any], *,
                          device: Union[str, torch.device, None] = "cuda",
                          seed: int = 0,
                          params_npz: Optional[str] = None) -> DiffSepTrainer:
    """Waveform-domain trainer from a diffsep-family config, on ``device``,
    with seeded random weights or, given ``params_npz``, the JAX package's
    exported parameters. The config is read as the JAX package reads it:
    ``trainer.accumulate_grad_batches`` is not read (1)."""
    m = cfg["model"]
    if m["score_model"]["kind"] == "LatentScoreModelNCSNpp":
        raise ValueError(f"config {cfg.get('name')!r} is a latent one: "
                         "build it with build_latent_trainer")
    model = build_score_model(m["score_model"], device=device, seed=seed)
    if params_npz:
        load_params_npz(params_npz, model)
    return DiffSepTrainer(model=model, sde=build_sde(m["sde"]),
                          cfg=_diffsep_cfg(m))


def build_latent_trainer(cfg: Dict[str, Any], *,
                         device: Union[str, torch.device, None] = "cuda",
                         seed: int = 0, params_npz: Optional[str] = None,
                         vae_params_npz: Optional[str] = None
                         ) -> LatentDiffSepTrainer:
    """Latent-domain trainer from a latent_diffsep_ouve-family config, on
    ``device``: the score model and the frozen VAE each with weights
    seeded by ``seed`` or the JAX package's ``.npz`` exports
    (``params_npz``, ``vae_params_npz``)."""
    m = cfg["model"]
    model = build_score_model(m["score_model"], device=device, seed=seed)
    if params_npz:
        load_params_npz(params_npz, model)
    vae = build_oobleck_vae(m["vae"], device=device, seed=seed,
                            params_npz=vae_params_npz)
    return LatentDiffSepTrainer(model=model, sde=build_sde(m["sde"]),
                                cfg=_diffsep_cfg(m), vae=vae)
