"""Demo callbacks: media generated periodically during training and
logged as audio (port of ditsep_tpu/training/demo.py; reference:
stable-audio-tools training/factory.py:160-245 create_demo_callback_from
_config, the autoencoder, diffusion and LM demo callbacks).

A callback is a frozen dataclass; the loop calls it after each step where
``cb.due(step)``: ``fit(callbacks=...)`` calls ``cb(logger, step,
trainer, state, generator)``, ``cli.train_stable`` the stable-audio
callbacks with the model (the EMA's, for the diffusion and LM ones) and
its draws. The audio lands in the ``MetricsLogger``'s TensorBoard or
wandb sink. The JAX loop swallows any failure of a callback; here only
the logging is guarded (printed and counted in ``logger.failures``), so
that generation (and any kernel it runs) that fails stops the run.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def _log_wavs(logger, tag: str, audio, step: int, fs: int,
              limit: int) -> None:
    """``audio`` (B, ...) as ``tag/i``, one wav an item, the first
    ``limit`` items."""
    a = (audio.detach().float().cpu().numpy()
         if isinstance(audio, torch.Tensor) else np.asarray(audio))
    for i in range(min(a.shape[0], limit)):
        logger.log_audio(f"{tag}/{i}", a[i].reshape(-1), step, fs=fs)


@dataclasses.dataclass(frozen=True)
class SeparationDemoCallback:
    """Separate a fixed demo batch every ``demo_every`` steps with the EMA
    weights and log the mixtures, the estimates and the targets
    (``demo/mix/i``, then ``demo/est_{s}/i`` and ``demo/target_{s}/i`` by
    source)."""

    demo_batch: Any  # (mix (B, 1, T), target (B, n, T)) numpy arrays
    demo_every: int = 2000
    sample_rate: int = 8000
    max_num_sample: int = 2
    sampler_N: Optional[int] = None  # None: the trainer's N

    def due(self, step: int) -> bool:
        return self.demo_every > 0 and step % self.demo_every == 0

    def __call__(self, logger, step: int, trainer, state,
                 generator: torch.Generator) -> None:
        """Separates on the device of ``state.ema``, drawing from
        ``generator``; ``trainer.separate(mix, model=, generator=[, N=])``
        returns (estimates, nfe). A failing separation raises; a failing
        log call is printed and counted (``logger.guarded``)."""
        mix, target = self.demo_batch
        device = next(state.ema.parameters()).device
        mix = torch.as_tensor(np.asarray(mix, np.float32), device=device)
        kw = {"N": self.sampler_N} if self.sampler_N else {}
        est, _ = trainer.separate(mix, model=state.ema, generator=generator,
                                  **kw)
        logger.guarded("demo", step, self._log, logger, step, mix, est,
                       np.asarray(target))

    def _log(self, logger, step, mix, est, target) -> None:
        _log_wavs(logger, "demo/mix", mix, step, self.sample_rate,
                  self.max_num_sample)
        for s in range(est.shape[1]):
            _log_wavs(logger, f"demo/est_{s}", est[:, s:s + 1], step,
                      self.sample_rate, self.max_num_sample)
            _log_wavs(logger, f"demo/target_{s}", target[:, s:s + 1], step,
                      self.sample_rate, self.max_num_sample)


@dataclasses.dataclass(frozen=True)
class AutoencoderDemoCallback:
    """Reconstruct a fixed batch (the posterior's mode, or a sample with
    ``generator``) and log ``demo/real/i`` and ``demo/recon/i`` (reference:
    training/autoencoders.py AutoencoderDemoCallback)."""

    demo_every: int = 2000
    sample_rate: int = 8000
    max_num_sample: int = 4

    def due(self, step: int) -> bool:
        return self.demo_every > 0 and step % self.demo_every == 0

    def __call__(self, logger, step: int, model, demo_reals,
                 generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            rec = model.decode(model.encode(demo_reals, generator=generator))
        logger.guarded("demo", step, self._log, logger, step, demo_reals,
                       rec)

    def _log(self, logger, step, reals, rec) -> None:
        _log_wavs(logger, "demo/real", reals, step, self.sample_rate,
                  self.max_num_sample)
        _log_wavs(logger, "demo/recon", rec, step, self.sample_rate,
                  self.max_num_sample)


def _accepted_kwargs(model) -> Optional[set]:
    """The keyword arguments ``model``'s forward takes (None: any)."""
    params = inspect.signature(type(model).forward).parameters
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return None
    return set(params)


@dataclasses.dataclass(frozen=True)
class DiffusionDemoCallback:
    """Sample ``num_demos`` items through ``generate_diffusion_cond`` at
    each CFG scale of ``demo_cfg_scales`` and log ``demo/cfg_{scale}/i``
    (reference: the Diffusion{Uncond,Cond,CondInpaint,Prior,Autoencoder}
    DemoCallbacks, which differ only in the conditioning the caller
    passes). One start noise serves every scale, as the JAX callback's one
    key; a net whose forward takes no CFG or conditioning keywords (DAU1d)
    gets only those it takes."""

    demo_every: int = 2000
    demo_steps: int = 250
    sample_size: int = 65536
    sample_rate: int = 8000
    io_channels: int = 64
    num_demos: int = 4
    demo_cfg_scales: Sequence[float] = (1.0,)
    diffusion_objective: str = "v"

    def due(self, step: int) -> bool:
        return self.demo_every > 0 and step % self.demo_every == 0

    def __call__(self, logger, step: int, model,
                 generator: Optional[torch.Generator] = None,
                 cond_inputs: Optional[Dict[str, Any]] = None,
                 pretransform=None, noise: Optional[torch.Tensor] = None
                 ) -> None:
        """``noise`` the start (B, channels, length), or drawn from
        ``generator``."""
        from ditsep_tpu_torch.inference.generation import (
            generate_diffusion_cond, initial_noise)

        accepted = _accepted_kwargs(model)

        def model_fn(x, t, **kw):
            if accepted is not None:
                kw = {k: v for k, v in kw.items() if k in accepted}
            return model(x, t, **kw)

        if noise is None:
            noise = initial_noise(self.num_demos, self.io_channels,
                                  self.sample_size, generator, pretransform)
        for scale in self.demo_cfg_scales:
            with torch.no_grad():
                audio = generate_diffusion_cond(
                    model_fn, steps=self.demo_steps, cfg_scale=float(scale),
                    batch_size=self.num_demos, sample_size=self.sample_size,
                    io_channels=self.io_channels, cond_inputs=cond_inputs,
                    diffusion_objective=self.diffusion_objective,
                    pretransform=pretransform, noise=noise)
            logger.guarded("demo", step, _log_wavs, logger,
                           f"demo/cfg_{scale:g}", audio, step,
                           self.sample_rate, self.num_demos)


@dataclasses.dataclass(frozen=True)
class LMDemoCallback:
    """Generate token grids from the LM (``lm_generate``: temperature 1,
    no top-k / top-p) and log their range (``demo/token_min``,
    ``demo/token_max``) and, through a discrete pretransform's
    ``decode_tokens``, the audio ``demo/lm/i`` (reference: training/lm.py
    AudioLanguageModelDemoCallback)."""

    demo_every: int = 2000
    sample_size: int = 65536
    sample_rate: int = 8000
    num_demos: int = 4
    pattern: Any = None

    def due(self, step: int) -> bool:
        return self.demo_every > 0 and step % self.demo_every == 0

    def __call__(self, logger, step: int, model,
                 generator: Optional[torch.Generator] = None,
                 pretransform=None, length: Optional[int] = None,
                 gumbel: Optional[Sequence[torch.Tensor]] = None) -> None:
        """``length`` frames (None: ``sample_size`` over the
        pretransform's hop, or 2048); the draws ``gumbel`` (one (B, n_q,
        codebook) a step) or from ``generator``."""
        from ditsep_tpu_torch.models.lm import lm_generate

        if length is None:
            ratio = (pretransform.downsampling_ratio
                     if pretransform is not None else 2048)
            length = max(self.sample_size // ratio, 1)
        tokens = lm_generate(model, self.num_demos, length,
                             pattern=self.pattern, generator=generator,
                             gumbel=gumbel)
        audio = None
        if pretransform is not None:
            with torch.no_grad():
                audio = pretransform.decode_tokens(tokens)
        logger.guarded("demo", step, self._log, logger, step, tokens, audio)

    def _log(self, logger, step, tokens, audio) -> None:
        logger.log({"demo/token_min": float(tokens.min()),
                    "demo/token_max": float(tokens.max())}, step)
        if audio is not None:
            _log_wavs(logger, "demo/lm", audio, step, self.sample_rate,
                      self.num_demos)


def create_demo_callback_from_config(model_config: Dict[str, Any],
                                     **kwargs):
    """The demo callback of ``model_config``'s model_type (reference:
    training/factory.py:160-245); ``io_channels`` and ``pattern`` may come
    as keywords."""
    model_type = model_config.get("model_type")
    if model_type is None:
        raise ValueError("model_type must be specified")
    training = model_config.get("training")
    if training is None:
        raise ValueError("training config must be specified")
    demo = training.get("demo", {})
    common = dict(demo_every=demo.get("demo_every", 2000),
                  sample_rate=model_config.get("sample_rate", 8000))
    if model_type == "autoencoder":
        return AutoencoderDemoCallback(
            max_num_sample=demo.get("max_num_sample", 4), **common)
    if model_type in ("diffusion_uncond", "diffusion_cond",
                      "diffusion_cond_inpaint", "diffusion_prior",
                      "diffusion_autoencoder"):
        model = model_config.get("model", {})
        # the cond schema's model.diffusion.io_channels; the uncond one's
        # model.config.io_channels (the dance_diffusion DAU1d configs)
        io_ch = model.get("diffusion", {}).get(
            "io_channels", model.get("config", {}).get(
                "io_channels", model.get("io_channels", 64)))
        return DiffusionDemoCallback(
            demo_steps=demo.get("demo_steps", 250),
            sample_size=model_config.get("sample_size", 65536),
            io_channels=kwargs.get("io_channels", io_ch),
            num_demos=demo.get("num_demos", 4),
            demo_cfg_scales=tuple(demo.get("demo_cfg_scales", (1.0,))),
            diffusion_objective=model.get("diffusion", {}).get(
                "diffusion_objective", "v"), **common)
    if model_type == "lm":
        return LMDemoCallback(
            sample_size=model_config.get("sample_size", 65536),
            num_demos=demo.get("num_demos", 4),
            pattern=kwargs.get("pattern"), **common)
    raise NotImplementedError(f"Unknown model type: {model_type}")
