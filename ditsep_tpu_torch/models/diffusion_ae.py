"""The diffusion autoencoder: a deterministic encoder to a compact latent
and a diffusion decoder conditioned on it by input concatenation (port of
ditsep_tpu/models/diffusion_ae.py; reference: stable-audio-tools
autoencoders.py create_diffAE_from_config, diffusion.py
DiffusionAutoencoder). Decoding runs the v-objective DDIM sampler
(``inference.sampling.sample``) from noise.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ditsep_tpu_torch.inference.sampling import sample

Tensor = torch.Tensor


class DiffusionAutoencoder(nn.Module):
    """``encoder`` (B, C, T) -> (B, D, T / downsampling_ratio) (None: the
    latents come from elsewhere); ``diffusion`` predicts v from (x (B,
    io_channels + D, T), t), the latent repeated to T beside the noised
    audio."""

    def __init__(self, encoder: Optional[nn.Module], diffusion: nn.Module,
                 latent_dim: int, downsampling_ratio: int,
                 io_channels: int = 1):
        super().__init__()
        self.encoder, self.diffusion = encoder, diffusion
        self.latent_dim, self.io_channels = latent_dim, io_channels
        self.downsampling_ratio = downsampling_ratio

    def encode(self, audio: Tensor) -> Tensor:
        return self.encoder(audio)

    @staticmethod
    def _cond(latents: Tensor, t_len: int) -> Tensor:
        reps = -(-t_len // latents.shape[-1])
        return torch.repeat_interleave(latents, reps, dim=-1)[..., :t_len]

    def diffusion_input(self, noised: Tensor, t: Tensor,
                        latents: Tensor) -> Tensor:
        """The diffusion net's v at (noised, t), the nearest-upsampled
        latent concatenated on the channel axis."""
        cond = self._cond(latents, noised.shape[-1]).to(noised)
        return self.diffusion(torch.cat([noised, cond], dim=1), t)

    def decode(self, latents: Tensor, steps: int = 50,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Tensor] = None) -> Tensor:
        """Latents (B, D, Tl) -> audio (B, io_channels, Tl x ratio), from
        the standard-normal ``noise`` or one drawn from ``generator``."""
        shape = (latents.shape[0], self.io_channels,
                 latents.shape[-1] * self.downsampling_ratio)
        if noise is None:
            noise = torch.randn(shape, generator=generator,
                                device=generator.device)
        return sample(lambda x, t, **kw: self.diffusion_input(x, t, latents),
                      noise.to(latents), steps, eta=0.0)

    def reconstruct(self, audio: Tensor, steps: int = 50,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Tensor] = None) -> Tensor:
        return self.decode(self.encode(audio), steps, generator, noise)


__all__ = ["DiffusionAutoencoder"]
