"""Conditional generation (port of ditsep_tpu/inference/generation.py;
reference: stable-audio-tools inference/generation.py:12-429
``generate_diffusion_cond``): initial noise, optional init audio
(variations) and inpainting mask, the sampler by objective, the
pretransform's decode.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ditsep_tpu_torch.inference.sampling import sample, sample_k, sample_rf

Tensor = torch.Tensor


def initial_noise(batch_size: int, io_channels: int, sample_size: int,
                  generator: torch.Generator, pretransform=None) -> Tensor:
    """The standard-normal start of ``generate_diffusion_cond``, drawn
    from ``generator`` on its device: (B, io_channels, sample_size), or in
    the pretransform's latent space (its channels, sample_size / its
    ratio)."""
    if pretransform is not None:
        io_channels = pretransform.encoded_channels
        sample_size = sample_size // pretransform.downsampling_ratio
    return torch.randn((batch_size, io_channels, sample_size),
                       generator=generator, device=generator.device)


def generate_diffusion_cond(
    model_fn: Callable[..., Tensor],
    *,
    steps: int = 100,
    cfg_scale: float = 6.0,
    batch_size: int = 1,
    sample_size: int = 2097152,
    io_channels: int = 64,
    cond_inputs: Optional[Dict[str, Any]] = None,
    negative_cond_inputs: Optional[Dict[str, Any]] = None,
    init_audio: Optional[Tensor] = None,
    init_noise_level: float = 1.0,
    mask_args: Optional[Dict[str, Any]] = None,
    diffusion_objective: str = "v",
    sampler_type: Optional[str] = None,
    pretransform=None,
    scale_phi: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tensor] = None,
) -> Tensor:
    """Sample latents (or audio) from a conditional diffusion model.

    ``model_fn(x, t, **cond_inputs)`` applies CFG itself (the
    ``DiffusionTransformer`` call). The start is ``noise`` or
    ``initial_noise`` from ``generator``. 'v' models take the DDIM
    sampler, or the Karras Heun sampler with ``sampler_type='k-heun'``;
    'rectified_flow' models ``sample_rf`` (``sampler_type`` euler / rk4 /
    dpmpp). ``init_audio`` (encoded by the pretransform's mode) starts a
    variation at ``init_noise_level``; with it, ``mask_args["mask"]`` (B, 1,
    latent_len) in [0, 1] keeps init content where 0 at the end."""
    if noise is None:
        noise = initial_noise(batch_size, io_channels, sample_size,
                              generator, pretransform)
    cond = dict(cond_inputs or {})
    if negative_cond_inputs:
        cond.update({f"negative_{k}": v
                     for k, v in negative_cond_inputs.items()})
    cond["cfg_scale"] = cfg_scale
    cond["scale_phi"] = scale_phi

    init_latent = None
    if init_audio is not None:
        init_audio = init_audio.to(noise.device)
        init_latent = (pretransform.encode(init_audio)
                       if pretransform is not None else init_audio)

    def fn(x, t, **extra):
        return model_fn(x, t, **cond, **extra)

    if diffusion_objective == "rectified_flow":
        out = sample_rf(fn, noise, init_data=init_latent, steps=steps,
                        sampler_type=sampler_type or "euler",
                        sigma_max=(init_noise_level if init_latent is not None
                                   else 1.0))
    elif sampler_type == "k-heun":
        out = sample_k(fn, noise, steps=steps, init_data=init_latent)
    elif init_latent is not None:
        # a variation: blend init and noise at the starting sigma
        t0 = min(init_noise_level, 1.0)
        start = (init_latent * math.cos(t0 * math.pi / 2)
                 + noise * math.sin(t0 * math.pi / 2))
        out = sample(fn, start, steps, eta=0.0, sigma_max=t0)
    else:
        out = sample(fn, noise, steps, eta=0.0)

    if mask_args is not None and init_latent is not None:
        # keep init content where the mask is 0 (get_bmask's last step is
        # all ones, so the final blend takes the mask itself)
        mask = mask_args["mask"].to(out)
        out = init_latent * (1 - mask) + out * mask

    if pretransform is not None:
        out = pretransform.decode(out)
    return out


def build_mask(sample_size: int, mask_args: Dict[str, Any]) -> Tensor:
    """Percentage-based inpainting mask (sample_size,) in [0, 1], 1 =
    regenerate: ``maskstart`` / ``maskend`` / ``softnessL`` / ``softnessR``
    in percent, Hann-softened edges, scaled by 1 - ``marination``."""
    maskstart = math.floor(mask_args["maskstart"] / 100.0 * sample_size)
    maskend = math.ceil(mask_args["maskend"] / 100.0 * sample_size)
    softness_l = round(mask_args.get("softnessL", 0) / 100.0 * sample_size)
    softness_r = round(mask_args.get("softnessR", 0) / 100.0 * sample_size)
    marination = mask_args.get("marination", 0)
    mask = torch.zeros(sample_size)
    mask[maskstart:maskend] = 1.0
    if softness_l > 0:
        mask[maskstart:maskstart + softness_l] = _hanning32(
            2 * softness_l)[:softness_l]
    if softness_r > 0:
        mask[maskend - softness_r:maskend] = _hanning32(
            2 * softness_r)[softness_r:]
    if marination > 0:
        mask = mask * (1 - marination)
    return mask


def _hanning32(m: int) -> Tensor:
    """``jnp.hanning``'s float32 formula, 0.5 (1 - cos(2 pi n / (m - 1))),
    its cosine correctly rounded (XLA's float32 cosine is off it by up to
    an ulp)."""
    if m <= 1:
        return torch.ones(m)
    arg = np.float32(2 * np.pi) * np.arange(m, dtype=np.float32) / np.float32(
        m - 1)
    cos = np.cos(arg.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.float32(0.5) * (np.float32(1) - cos))
