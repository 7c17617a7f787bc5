"""Functional core of the demo interface, free of any UI framework (port of
ditsep_tpu/interface/app.py:33-170).

Each process function is a plain callable over numpy audio and scalar
knobs, so the demo is testable without a browser: the separation,
autoencoder, generation and token-LM backends and
``spectrogram_preview``. Models run on the device their parameters are on,
a ``seed`` seeds a generator there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_mono_batch(wav: np.ndarray) -> np.ndarray:
    """(T,) or (T, C) audio -> (1, 1, T) float32, peak-normalized."""
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:  # (T, C), as decode_wav gives it
        wav = wav.mean(axis=1)
    peak = float(np.abs(wav).max()) or 1.0
    return (wav / max(peak, 1e-6))[None, None, :]


def _peak_norm(x: np.ndarray) -> np.ndarray:
    return x / max(float(np.abs(x).max()), 1e-6)


@dataclasses.dataclass
class SeparationApp:
    """Separation tab backend: a ``DiffSepTrainer`` (its score model on
    the device it runs on) -> process function."""

    trainer: Any
    fs: int = 8000

    def process(self, wav: np.ndarray, n_steps: int = 30,
                snr: float = 0.5, corrector_steps: int = 1,
                seed: int = 0) -> np.ndarray:
        """Separate one mixture: (n_src, T) estimates, peak-normalized.
        ``seed`` seeds a generator on the trainer's device."""
        device = next(self.trainer.model.parameters()).device
        mix = torch.from_numpy(_to_mono_batch(wav)).to(device)
        generator = torch.Generator(device=device).manual_seed(int(seed))
        est, _ = self.trainer.separate(
            mix, N=int(n_steps), snr=float(snr),
            corrector_steps=int(corrector_steps), generator=generator)
        return _peak_norm(est[0].float().cpu().numpy())


def _device(module) -> torch.device:
    return next(module.parameters()).device


@dataclasses.dataclass
class AutoencoderApp:
    """Autoencoder tab backend: encode (the posterior mean), optional
    latent noise, decode. The input is folded to mono, so the tab serves
    mono autoencoders, as the JAX package's."""

    vae: Any
    fs: int = 8000

    def process(self, wav: np.ndarray, latent_noise: float = 0.0,
                seed: int = 0) -> np.ndarray:
        device = _device(self.vae)
        x = torch.from_numpy(_to_mono_batch(wav)).to(device)
        with torch.no_grad():
            lat = self.vae.encode(x)
            if latent_noise > 0:
                g = torch.Generator(device=device).manual_seed(int(seed))
                lat = lat + latent_noise * torch.randn(
                    lat.shape, generator=g, device=device)
            rec = self.vae.decode(lat)
        return _peak_norm(rec[0].float().cpu().numpy().reshape(-1))


@dataclasses.dataclass
class GenerationApp:
    """Unconditional and conditional diffusion generation backends: a
    ``DiffusionTransformer`` (``model``), with ``routing`` and
    ``conditioner`` for the conditional tab and, where the model samples
    latents, the ``pretransform`` that decodes them (the JAX package's app
    samples in the model's own space only). ``io_channels`` is the model's
    width, ``sample_size`` the output length in audio samples. The model's
    ``diffusion_objective`` picks the sampler family, where the JAX
    package's app always samples as 'v'."""

    model: Any
    io_channels: int = 1
    sample_size: int = 32768
    fs: int = 8000
    routing: Any = None
    conditioner: Any = None
    pretransform: Any = None

    @property
    def audio_channels(self) -> int:
        return (self.pretransform.io_channels if self.pretransform is not None
                else self.io_channels)

    def initial_noise(self, batch: int = 1, seed: int = 0) -> torch.Tensor:
        """The start that ``generate_conditional(seed=seed)`` draws."""
        from ditsep_tpu_torch.inference.generation import initial_noise

        device = _device(self.model)
        g = torch.Generator(device=device).manual_seed(int(seed))
        return initial_noise(batch, self.io_channels, self.sample_size, g,
                             self.pretransform)

    def generate_uncond(self, steps: int = 50, batch: int = 1,
                        seed: int = 0, sigma_min: float = 0.3,
                        sigma_max: float = 50.0,
                        noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """The Karras Heun sampler from the seed's noise (or ``noise``), no
        conditioning; decoded by the pretransform where there is one;
        peak-normalized."""
        from ditsep_tpu_torch.inference.sampling import sample_k

        if noise is None:
            noise = self.initial_noise(batch, seed)
        with torch.no_grad():
            out = sample_k(lambda x, t: self.model(x, t), noise,
                           steps=int(steps), sigma_min=float(sigma_min),
                           sigma_max=float(sigma_max))
            if self.pretransform is not None:
                out = self.pretransform.decode(out)
        return _peak_norm(out.float().cpu().numpy())

    def generate_conditional(self, cond_inputs: Dict[str, Any],
                             steps: int = 50, cfg_scale: float = 6.0,
                             batch: int = 1, seed: int = 0,
                             sampler_type: Optional[str] = None,
                             init_audio: Optional[np.ndarray] = None,
                             init_noise_level: float = 1.0,
                             inpaint_mask: Optional[np.ndarray] = None,
                             noise: Optional[torch.Tensor] = None
                             ) -> np.ndarray:
        """Conditional generation with the reference tab's knobs:
        ``init_audio`` (folded to mono, padded or cut to sample_size) and
        ``init_noise_level`` give a variation; ``inpaint_mask`` (1 =
        regenerate, 0 = keep the init content; (latent_len,) or (B, 1,
        latent_len)) inpaints. ``noise`` replaces the seed's start."""
        from ditsep_tpu_torch.inference.generation import (
            generate_diffusion_cond)

        if self.routing is None or self.conditioner is None:
            raise ValueError("conditional generation needs a routing and a "
                             "conditioner")
        device = _device(self.model)
        init = None
        if init_audio is not None:
            init = _to_mono_batch(np.asarray(init_audio))
            t = init.shape[-1]
            if t < self.sample_size:
                init = np.pad(init, [(0, 0), (0, 0),
                                     (0, self.sample_size - t)])
            init = torch.from_numpy(np.ascontiguousarray(
                init[..., :self.sample_size])).to(device).expand(
                batch, self.audio_channels, self.sample_size)
        mask_args = None
        if inpaint_mask is not None:
            m = torch.as_tensor(np.asarray(inpaint_mask, np.float32),
                                device=device)
            if m.ndim != 3:
                m = m.reshape(1, 1, -1)
            mask_args = {"mask": m.expand(batch, 1, m.shape[-1])}
        if noise is None:
            noise = self.initial_noise(batch, seed)
        with torch.no_grad():
            cond = self.routing.gather(self.conditioner(cond_inputs))
            out = generate_diffusion_cond(
                self.model, steps=int(steps), cfg_scale=float(cfg_scale),
                batch_size=batch, sample_size=self.sample_size,
                io_channels=self.io_channels, cond_inputs=cond,
                init_audio=init, init_noise_level=float(init_noise_level),
                mask_args=mask_args, sampler_type=sampler_type,
                diffusion_objective=self.model.diffusion_objective,
                pretransform=self.pretransform, noise=noise)
        return out.float().cpu().numpy()


@dataclasses.dataclass
class LMApp:
    """The token-LM backend: ``lm_generate`` (temperature, top-k, top-p;
    the Gumbel draws from a generator seeded with ``seed`` on the LM's
    device) for one item of ``length`` frames in the delay pattern,
    decoded by ``decode_tokens`` (codes (1, Q, length) -> audio, e.g. a
    ``DACPretransform``'s) where one is given."""

    lm: Any
    decode_tokens: Optional[Any] = None
    fs: int = 8000

    def process(self, length: int = 64, temperature: float = 1.0,
                top_k: int = 250, top_p: float = 0.0,
                seed: int = 0) -> np.ndarray:
        """Codes (1, n_q, length) as int64 without a decoder; with one,
        its audio peak-normalized."""
        from ditsep_tpu_torch.models.lm import lm_generate

        g = torch.Generator(device=_device(self.lm)).manual_seed(int(seed))
        codes = lm_generate(self.lm, 1, int(length),
                            temperature=float(temperature), top_k=int(top_k),
                            top_p=float(top_p), generator=g)
        if self.decode_tokens is None:
            return codes.cpu().numpy()
        with torch.no_grad():
            audio = self.decode_tokens(codes)
        return _peak_norm(audio.float().cpu().numpy())


def spectrogram_preview(wav: np.ndarray, fs: int = 8000):
    """Matplotlib spectrogram figure of a waveform, for UI previews."""
    from ditsep_tpu_torch.viz import spectrogram_image

    return spectrogram_image(np.asarray(wav).reshape(-1), fs=fs)
