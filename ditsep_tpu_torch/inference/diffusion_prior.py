"""Diffusion priors: mono-to-stereo generation (port of
ditsep_tpu/inference/diffusion_prior.py; reference: stable-audio-tools
models/diffusion_prior.py:16-78 ``MonoToStereoDiffusionPrior.stereoize``):
a stereo diffusion model conditioned on the input's dual-mono copy (as
input-concat channels) samples the stereo field.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ditsep_tpu_torch.inference.generation import generate_diffusion_cond

Tensor = torch.Tensor


def stereoize(model_fn, audio: Tensor, *, steps: int = 50,
              min_input_length: int = 1, pretransform=None,
              sampler_kwargs: Optional[Dict[str, Any]] = None,
              generator: Optional[torch.Generator] = None,
              noise: Optional[Tensor] = None) -> Tensor:
    """(B, C, T) audio -> (B, 2, T) stereo: the input is averaged to mono,
    padded to a multiple of ``min_input_length``, duplicated to two
    channels (encoded by ``pretransform`` where given) and routed as
    ``input_concat_cond``; ``model_fn`` as ``generate_diffusion_cond``'s,
    the start ``noise`` or drawn from ``generator``."""
    b, _, t = audio.shape
    pad = (min_input_length - t % min_input_length) % min_input_length
    if pad:
        audio = F.pad(audio, (0, pad))
    dual_mono = audio.mean(dim=1, keepdim=True).repeat(1, 2, 1)
    cond_source = (pretransform.encode(dual_mono)
                   if pretransform is not None else dual_mono)
    out = generate_diffusion_cond(
        model_fn, steps=steps, batch_size=b, sample_size=audio.shape[-1],
        io_channels=cond_source.shape[1],
        cond_inputs={"input_concat_cond": cond_source},
        pretransform=pretransform, generator=generator, noise=noise,
        **(sampler_kwargs or {}))
    return out[..., :t]
