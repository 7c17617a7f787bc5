"""The training-wrapper factory (port of ditsep_tpu/training/factory.py;
reference: stable-audio-tools training/factory.py:5-158): a model JSON
config's ``training`` block -> the trainer of its ``model_type``. The
trainers are frozen dataclasses whose state (the parameters in place,
the optimizer, the EMA copy) their ``init_state`` builds; ``train_step``
(``gen_step`` / ``disc_step`` for the autoencoder) drives them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def _opt_overrides(training: Dict[str, Any], group: str) -> Dict[str, Any]:
    """lr / betas / weight_decay of ``optimizer_configs[group]``, in the
    reference's AdamW schema (oobleck_finetune.json's
    training.optimizer_configs), as trainer fields."""
    out: Dict[str, Any] = {}
    oc = (training.get("optimizer_configs") or {}).get(group, {})
    c = oc.get("optimizer", {}).get("config", {})
    if "lr" in c:
        out["lr"] = c["lr"]
    if "betas" in c:
        out["b1"], out["b2"] = c["betas"]
    if "weight_decay" in c:
        out["weight_decay"] = c["weight_decay"]
    return out


def _autoencoder_trainer(model_config: Dict[str, Any], model,
                         training: Dict[str, Any],
                         generator: Optional[torch.Generator]):
    """(reference: factory.py:12-56 -> AutoencoderTrainingWrapper)."""
    from ditsep_tpu_torch.models.discriminators import (
        create_discriminator_from_config)
    from ditsep_tpu_torch.training.autoencoder import (
        AutoencoderLossConfig, AutoencoderTrainer)
    from ditsep_tpu_torch.training.schedules import (
        create_optimizer_from_config)

    lc = training.get("loss_configs") or {}
    weights: Dict[str, float] = {}
    for grp in ("spectral", "time", "bottleneck", "discriminator"):
        weights.update((lc.get(grp) or {}).get("weights", {}))
    sample_rate = int(model_config.get("sample_rate", 8000))
    loss_cfg = AutoencoderLossConfig(
        mrstft=weights.get("mrstft", 1.0), l1=weights.get("l1", 0.0),
        kl=weights.get("kl", 1e-4),
        adversarial=weights.get("adversarial", 0.1),
        feature_matching=weights.get("feature_matching", 5.0),
        sample_rate=sample_rate)
    disc = None
    if lc.get("discriminator") is not None:
        # the model's channel count and rate: a stereo config takes a
        # stereo discriminator, a 44.1 kHz one banks laid out for it
        audio_ch = (model_config.get("model", {}).get("encoder", {})
                    .get("config", {}).get("in_channels")
                    or model_config.get("audio_channels", 1))
        disc = create_discriminator_from_config(
            lc["discriminator"], in_channels=int(audio_ch),
            sample_rate=sample_rate)
        disc.reset_parameters(generator or torch.Generator().manual_seed(0))

    def tx_for(group):
        oc = (training.get("optimizer_configs") or {}).get(group)
        if oc is None or "optimizer" not in oc:
            return None
        return create_optimizer_from_config(oc["optimizer"],
                                            oc.get("scheduler"))

    teacher = None
    t_cfg = training.get("teacher_model")
    if t_cfg is not None:
        # (reference: factory.py:29-40) the teacher comes from its own
        # model config and must come with its weights
        ckpt = training.get("teacher_model_ckpt")
        if ckpt is None:
            raise ValueError("teacher_model_ckpt must be specified if "
                             "teacher_model is specified")
        from ditsep_tpu_torch.models.factory import create_model_from_config
        from ditsep_tpu_torch.models.weights import load_params_npz
        teacher = load_params_npz(ckpt, create_model_from_config(t_cfg))

    return AutoencoderTrainer(
        vae=model, disc=disc, loss_cfg=loss_cfg,
        lr=training.get("learning_rate", 1.5e-4),
        warmup_steps=training.get("warmup_steps", 0),
        encoder_freeze_on_warmup=training.get("encoder_freeze_on_warmup",
                                              False),
        latent_mask_ratio=training.get("latent_mask_ratio", 0.0),
        teacher_vae=teacher, vae_tx=tx_for("autoencoder"),
        disc_tx=tx_for("discriminator"))


def create_trainer_from_config(model_config: Dict[str, Any], model,
                               generator: Optional[torch.Generator] = None):
    """The trainer of ``model_config``'s model_type (reference: training/
    factory.py:5-158) for ``model``, what ``models.factory.
    create_model_from_config`` built from the same config (a (net,
    routing, conditioner configs) tuple for the conditional types, (lm,
    pattern) for 'lm'). An autoencoder's discriminator is built on the
    default device and seeded from ``generator`` (seed 0 by default)."""
    model_type = model_config.get("model_type")
    if model_type is None:
        raise ValueError("model_type must be specified")
    training = model_config.get("training")
    if training is None:
        raise ValueError("training config must be specified")

    if model_type == "autoencoder":
        return _autoencoder_trainer(model_config, model, training, generator)
    if model_type == "diffusion_autoencoder":
        # (reference: factory.py:119-136)
        from ditsep_tpu_torch.training.diffusion import DiffAETrainer
        return DiffAETrainer(
            model=model, lr=training.get("learning_rate", 1e-4),
            timestep_sampler=training.get("timestep_sampler", "uniform"))
    if model_type in ("diffusion_uncond", "diffusion_cond",
                      "diffusion_cond_inpaint", "diffusion_prior"):
        # (reference: factory.py:57-118); diffusion_prior trains the same
        # conditioned objective, its mono / stereo pair made by the data
        # path or inference.diffusion_prior.stereoize
        from ditsep_tpu_torch.training.diffusion import DiffusionTrainer
        net, routing = (model[0], model[1]) if isinstance(model, tuple) \
            else (model, None)
        return DiffusionTrainer(
            model=net,
            objective=model_config.get("model", {}).get(
                "diffusion", {}).get("diffusion_objective", "v"),
            timestep_sampler=training.get("timestep_sampler", "uniform"),
            lr=training.get("learning_rate", 1e-4),
            cfg_dropout_prob=training.get("cfg_dropout_prob", 0.1),
            routing=routing,
            inpaint=model_type == "diffusion_cond_inpaint",
            max_mask_segments=training.get("max_mask_segments", 10),
            mono_stereo_prior=(model_type == "diffusion_prior"
                               and training.get("prior_type", "mono_stereo")
                               == "mono_stereo"))
    if model_type == "lm":
        # (reference: factory.py:137-155)
        from ditsep_tpu_torch.training.lm import LMTrainer
        lm, pattern = model if isinstance(model, tuple) else (model, None)
        kw = {"lr": training.get("learning_rate", 1e-4),
              **_opt_overrides(training, "lm")}
        return LMTrainer(model=lm, pattern=pattern, **kw)
    raise NotImplementedError(f"Unknown model type: {model_type}")
