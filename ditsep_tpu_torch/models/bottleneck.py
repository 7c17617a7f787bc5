"""Latent bottlenecks: VAE, Tanh, Wasserstein (MMD), L2, residual VQ, FSQ,
dithered FSQ and the DAC residual VQs (port of
ditsep_tpu/models/bottleneck.py; reference: stable-audio-tools
models/bottleneck.py:33-435 and fsq.py:26-131).

Every bottleneck is (B, C, T) channel first: ``encode(x, return_info=False,
...)`` -> latents (and an info dict), ``decode(x)`` -> latents. Where the
JAX package takes a PRNG key, the port takes a ``generator`` or the draws
themselves (``noise=``, standard normal; the dithered FSQ's ``draws=``), so
tests hand both packages the same numbers. The bottlenecks with
parameters (the residual VQs) are ``nn.Module``s; their ``quantizer``
carries the JAX package's flax names (``codebook_{q}``, ``in_proj_{q}``,
``out_proj_{q}``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ditsep_tpu_torch.models.oobleck import vae_sample
from ditsep_tpu_torch.models.transformer import Dense

Tensor = torch.Tensor


def _normal(shape, like: Tensor, generator: Optional[torch.Generator],
            noise: Optional[Tensor]) -> Tensor:
    if noise is not None:
        return noise.to(device=like.device, dtype=like.dtype)
    if generator is None:
        raise ValueError("a sampling bottleneck needs a generator or noise")
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=like.dtype).to(like.device)


def _l2_normalize(x: Tensor, dim: int) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(1e-12)


@dataclasses.dataclass(frozen=True)
class TanhBottleneck:
    """tanh(x / scale) * scale."""

    scale: float = 1.0

    def encode(self, x, return_info=False):
        y = torch.tanh(x / self.scale) * self.scale
        return (y, {}) if return_info else y

    def decode(self, x):
        return x


@dataclasses.dataclass(frozen=True)
class VAEBottleneck:
    """x carries 2 x latent channels (mean, scale): a posterior sample
    with ``generator`` or ``noise`` (B, D, T), else the mean; KL in
    info."""

    def encode(self, x, return_info=False, generator=None, noise=None):
        mean, scale = x.chunk(2, dim=1)
        if generator is None and noise is None:
            latents, kl = mean, torch.zeros((), dtype=x.dtype,
                                            device=x.device)
        else:
            latents, kl = vae_sample(
                mean, scale, _normal(mean.shape, mean, generator, noise))
        return (latents, {"kl": kl}) if return_info else latents

    def decode(self, x):
        return x


def compute_mmd(latents: Tensor, generator=None, noise=None) -> Tensor:
    """Gaussian-kernel MMD of the (B, C, T) latents' frames against a
    standard normal sample of the same (B * T, C) shape."""
    z = latents.transpose(1, -1).reshape(-1, latents.shape[1])
    ref = _normal(z.shape, z, generator, noise)

    def mean_kernel(a, b):
        d = ((a[:, None] - b[None]) ** 2).mean(dim=2) / a.shape[-1]
        return torch.exp(-d).mean()

    return (mean_kernel(z, z) + mean_kernel(ref, ref)
            - 2 * mean_kernel(z, ref))


@dataclasses.dataclass(frozen=True)
class WassersteinBottleneck:
    """MMD regulariser in info while training, optional tanh; ``decode``
    appends ``noise_augment_dim`` channels of noise."""

    noise_augment_dim: int = 0
    bypass_mmd: bool = False
    use_tanh: bool = False
    tanh_scale: float = 5.0

    def encode(self, x, return_info=False, training=True, generator=None,
               noise=None):
        info = {}
        if training and return_info:
            info["mmd"] = (torch.zeros((), device=x.device) if self.bypass_mmd
                           else compute_mmd(x, generator, noise))
        if self.use_tanh:
            x = torch.tanh(x / self.tanh_scale) * self.tanh_scale
        return (x, info) if return_info else x

    def decode(self, x, generator=None, noise=None):
        if self.noise_augment_dim > 0:
            shape = (x.shape[0], self.noise_augment_dim, x.shape[-1])
            x = torch.cat([x, _normal(shape, x, generator, noise)], dim=1)
        return x


@dataclasses.dataclass(frozen=True)
class L2Bottleneck:
    """Unit norm over the channel axis, both ways."""

    def encode(self, x, return_info=False):
        y = _l2_normalize(x, 1)
        return (y, {}) if return_info else y

    def decode(self, x):
        return _l2_normalize(x, 1)


class ResidualVQ(nn.Module):
    """Residual vector quantizer over (B, N, D): the nearest code of each
    stage's residual, straight-through gradients, codebook + commitment
    loss; codebooks ``codebook_{q}`` (size, dim) learned by gradient."""

    def __init__(self, dim: int, codebook_size: int = 1024,
                 num_quantizers: int = 4, commitment_weight: float = 0.25):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.num_quantizers = num_quantizers
        self.commitment_weight = commitment_weight
        for q in range(num_quantizers):
            self.register_parameter(f"codebook_{q}", nn.Parameter(
                torch.randn(codebook_size, dim)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for q in range(self.num_quantizers):
                self.codebook(q).normal_(generator=generator)

    def codebook(self, q: int) -> Tensor:
        return getattr(self, f"codebook_{q}")

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """-> (quantized (B, N, D), indices (B, N, Q), loss)."""
        residual, quantized = x, torch.zeros_like(x)
        indices, loss = [], 0.0
        for q in range(self.num_quantizers):
            cb = self.codebook(q)
            d = ((residual ** 2).sum(-1, keepdim=True)
                 - 2 * residual @ cb.T + (cb ** 2).sum(-1)[None, None, :])
            idx = d.argmin(dim=-1)
            sel = cb[idx]
            loss = loss + ((residual.detach() - sel) ** 2).mean()
            loss = loss + self.commitment_weight * (
                (residual - sel.detach()) ** 2).mean()
            quantized = quantized + (residual + (sel - residual).detach())
            residual = residual - sel.detach()
            indices.append(idx)
        return quantized, torch.stack(indices, dim=-1), loss

    def from_indices(self, indices: Tensor) -> Tensor:
        return sum(self.codebook(q)[indices[..., q]]
                   for q in range(self.num_quantizers))


class RVQBottleneck(nn.Module):
    """``ResidualVQ`` over the frames of (B, D, T)."""

    def __init__(self, quantizer: ResidualVQ):
        super().__init__()
        self.quantizer = quantizer

    def encode(self, x, return_info=False):
        q, idx, loss = self.quantizer(x.transpose(1, -1))
        q = q.transpose(1, -1)
        info = {"quantizer_indices": idx, "quantizer_loss": loss}
        return (q, info) if return_info else q

    def decode(self, x):
        return x

    def decode_tokens(self, codes):
        return self.quantizer.from_indices(codes).transpose(1, -1)


class RVQVAEBottleneck(RVQBottleneck):
    """A VAE sample of the (mean, scale) channels, then the residual VQ;
    KL in info."""

    def encode(self, x, return_info=False, generator=None, noise=None):
        mean, scale = x.chunk(2, dim=1)
        lat, kl = vae_sample(mean, scale,
                             _normal(mean.shape, mean, generator, noise))
        q, idx, loss = self.quantizer(lat.transpose(1, -1))
        q = q.transpose(1, -1)
        info = {"kl": kl, "quantizer_indices": idx,
                "quantizer_loss": loss.mean()}
        return (q, info) if return_info else q


def _round_ste(z: Tensor) -> Tensor:
    return z + (torch.round(z) - z).detach()


@dataclasses.dataclass(frozen=True)
class FSQBottleneck:
    """Finite scalar quantization (Mentzer et al. 2023), ``levels`` a
    latent channel; codes in about [-1, 1]."""

    levels: Sequence[int] = (8, 5, 5, 5)

    def _bound(self, z: Tensor) -> Tensor:
        lv = torch.tensor(self.levels, dtype=z.dtype, device=z.device)
        half_l = (lv - 1.0) / 2.0
        offset = torch.tensor([0.5 if lvl % 2 == 0 else 0.0
                               for lvl in self.levels], dtype=z.dtype,
                              device=z.device)
        shift = torch.atanh(offset / half_l.clamp_min(1e-6))
        return torch.tanh(z + shift) * half_l - offset

    def _half_width(self, z: Tensor) -> Tensor:
        return torch.tensor([lvl // 2 for lvl in self.levels],
                            dtype=z.dtype, device=z.device)

    def encode(self, x, return_info=False):
        z = x.transpose(1, -1)
        q = _round_ste(self._bound(z)) / self._half_width(z)
        q = q.transpose(1, -1)
        return (q, {}) if return_info else q

    def decode(self, x):
        return x

    def tokens(self, q_normalized: Tensor) -> Tensor:
        """Normalised codes (B, D, T) -> integer tokens (B, T)."""
        z = q_normalized.transpose(1, -1)
        lv = torch.tensor(self.levels, dtype=torch.int64, device=z.device)
        digits = (torch.round(z * self._half_width(z))
                  + (lv // 2)).to(torch.int64)
        basis = torch.cumprod(torch.cat(
            [torch.ones(1, dtype=torch.int64, device=z.device), lv[:-1]]), 0)
        return (digits * basis).sum(-1)


@dataclasses.dataclass(frozen=True)
class DitheredFSQ:
    """Dithered finite scalar quantization, parameter-free: ``levels`` a
    latent dim, replicated over ``num_codebooks`` channel groups. In
    training two per-row Bernoulli(noise_dropout) masks choose: the first
    keeps the continuous value instead of the rounded one, the second
    keeps that instead of a dithered value z + U(-0.5, 0.5) * step."""

    levels: Sequence[int]
    num_codebooks: int = 1
    noise_dropout: float = 0.5
    scale: float = 1.0

    @property
    def codebook_dim(self) -> int:
        return len(self.levels)

    @property
    def codebook_size(self) -> int:
        out = 1
        for lvl in self.levels:
            out *= lvl
        return out

    def _half_l(self, like: Tensor) -> Tensor:
        lv = torch.tensor(self.levels, dtype=like.dtype, device=like.device)
        return self.scale * 2.0 / (lv - 1.0)

    def _scale_and_shift(self, z: Tensor) -> Tensor:
        return (z + self.scale) / self._half_l(z)

    def _scale_and_shift_inverse(self, li: Tensor) -> Tensor:
        return li * self._half_l(li) - self.scale

    def quantize(self, z: Tensor, training: bool = False,
                 skip_tanh: bool = False, generator=None,
                 draws: Optional[Dict[str, Tensor]] = None) -> Tensor:
        """z (B, ..., d), grouped per codebook. ``draws``: ``keep`` and
        ``keep2`` boolean (B, 1, ...) masks and ``uniform`` U(0, 1) of z's
        shape; else drawn from ``generator``."""
        if not skip_tanh:
            z = torch.tanh(z)
        rounded = self._scale_and_shift_inverse(
            _round_ste(self._scale_and_shift(z)))
        if not training:
            return rounded
        mshape = (z.shape[0],) + (1,) * (z.ndim - 1)
        if draws is None:
            if generator is None:
                raise ValueError("training quantize needs a generator or "
                                 "draws")
            dev = generator.device
            draws = {
                "keep": torch.rand(mshape, generator=generator,
                                   device=dev) < self.noise_dropout,
                "keep2": torch.rand(mshape, generator=generator,
                                    device=dev) < self.noise_dropout,
                "uniform": torch.rand(z.shape, generator=generator,
                                      device=dev)}
        dv = {k: v.to(z.device) for k, v in draws.items()}
        q = torch.where(dv["keep"], z, rounded)
        dither = z + (dv["uniform"].to(z.dtype) - 0.5) * self._half_l(z)
        return torch.where(dv["keep2"], q, dither)

    def _basis(self, device) -> Tensor:
        return torch.cumprod(torch.tensor([1] + list(self.levels)[:-1],
                                          dtype=torch.int64, device=device),
                             0)

    def codes_to_indices(self, zhat: Tensor) -> Tensor:
        li = torch.round(self._scale_and_shift(zhat)).to(torch.int64)
        return (li * self._basis(zhat.device)).sum(-1)

    def indices_to_codes(self, indices: Tensor) -> Tensor:
        """indices (..., c) -> codes (..., c * d)."""
        lv = torch.tensor(self.levels, dtype=torch.int64,
                          device=indices.device)
        li = (indices[..., None] // self._basis(indices.device)) % lv
        codes = self._scale_and_shift_inverse(li.to(torch.float32))
        return codes.reshape(codes.shape[:-2] + (-1,))

    def __call__(self, z: Tensor, training: bool = False,
                 skip_tanh: bool = False, generator=None, draws=None):
        """z (B, N, c * d) -> (codes (B, N, c * d), indices (B, N, c));
        the indices of the rounded lattice point, also in training."""
        b, n, dim = z.shape
        if dim != self.num_codebooks * self.codebook_dim:
            raise ValueError(f"width {dim} is not {self.num_codebooks} "
                             f"codebooks x {self.codebook_dim}")
        zc = z.reshape(b, n, self.num_codebooks, self.codebook_dim)
        codes = self.quantize(zc.float(), training=training,
                              skip_tanh=skip_tanh, generator=generator,
                              draws=draws)
        rounded = self._scale_and_shift_inverse(
            torch.round(self._scale_and_shift(codes)))
        return (codes.reshape(b, n, dim).to(z.dtype),
                self.codes_to_indices(rounded))


@dataclasses.dataclass(frozen=True)
class DitheredFSQBottleneck:
    """``DitheredFSQ`` over the frames of (B, D, T); ``levels`` an int
    (replicated over ``dim``) or one per dim."""

    quantizer: DitheredFSQ

    @staticmethod
    def build(dim: int, levels, num_codebooks: int = 1,
              dither_inference: bool = True, noise_dropout: float = 0.05):
        if isinstance(levels, int):
            qlevels = [levels] * dim
        else:
            if len(levels) != dim:
                raise ValueError(
                    f"Length of levels list ({len(levels)}) must match "
                    f"dim ({dim}).")
            qlevels = list(levels)
        return DitheredFSQBottleneck(DitheredFSQ(
            levels=tuple(qlevels), num_codebooks=num_codebooks,
            noise_dropout=noise_dropout))

    def encode(self, x, return_info=False, training=False, generator=None,
               draws=None):
        q, idx = self.quantizer(x.transpose(1, -1), training=training,
                                generator=generator, draws=draws)
        q = q.transpose(1, -1)
        info = {"quantizer_indices": idx.transpose(1, -1)}
        return (q, info) if return_info else q

    def decode(self, x):
        return x

    def decode_tokens(self, tokens):
        """tokens (B, c, N) -> latents (B, c * d, N)."""
        return self.quantizer.indices_to_codes(
            tokens.transpose(1, -1)).transpose(1, -1)


class DACResidualVQ(nn.Module):
    """DAC-style residual VQ over (B, N, D_in): each stage projects the
    residual to ``codebook_dim`` (``in_proj_{q}``), takes the code of
    highest cosine similarity in ``codebook_{q}``, projects back
    (``out_proj_{q}``); commitment and codebook losses apart."""

    def __init__(self, input_dim: int, n_codebooks: int = 9,
                 codebook_size: int = 1024, codebook_dim: int = 8):
        super().__init__()
        self.input_dim, self.n_codebooks = input_dim, n_codebooks
        self.codebook_size, self.codebook_dim = codebook_size, codebook_dim
        for q in range(n_codebooks):
            self.add_module(f"in_proj_{q}", Dense(input_dim, codebook_dim))
            self.register_parameter(f"codebook_{q}", nn.Parameter(
                torch.randn(codebook_size, codebook_dim)))
            self.add_module(f"out_proj_{q}", Dense(codebook_dim, input_dim))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            for q in range(self.n_codebooks):
                getattr(self, f"in_proj_{q}").reset_parameters(generator)
                getattr(self, f"codebook_{q}").normal_(generator=generator)
                getattr(self, f"out_proj_{q}").reset_parameters(generator)

    def forward(self, x: Tensor, n_quantizers: Optional[int] = None):
        """-> (z (B, N, D_in), codes (B, N, Q), latents (B, N, Q * cd),
        commitment loss, codebook loss)."""
        n_q = (self.n_codebooks if n_quantizers is None
               else min(n_quantizers, self.n_codebooks))
        residual, z = x, torch.zeros_like(x)
        codes, latents = [], []
        commit = codebook_loss = 0.0
        for q in range(n_q):
            zq = getattr(self, f"in_proj_{q}")(residual)
            cb = getattr(self, f"codebook_{q}")
            zn = zq / (torch.linalg.vector_norm(zq, dim=-1, keepdim=True)
                       + 1e-8)
            cn = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True)
                       + 1e-8)
            idx = (zn @ cn.T).argmax(dim=-1)
            sel = cb[idx]
            commit = commit + ((zq - sel.detach()) ** 2).mean()
            codebook_loss = codebook_loss + ((zq.detach() - sel) ** 2).mean()
            out = getattr(self, f"out_proj_{q}")(zq + (sel - zq).detach())
            z = z + out
            residual = residual - out.detach()
            codes.append(idx)
            latents.append(zq)
        return (z, torch.stack(codes, dim=-1), torch.cat(latents, dim=-1),
                commit, codebook_loss)

    def from_codes(self, codes: Tensor) -> Tensor:
        """codes (B, N, Q) -> z (B, N, D_in)."""
        return sum(getattr(self, f"out_proj_{q}")(
            getattr(self, f"codebook_{q}")[codes[..., q]])
            for q in range(codes.shape[-1]))


class DACRVQBottleneck(nn.Module):
    """``DACResidualVQ`` over (B, C, T), its losses divided by the
    codebook count; ``quantize_on_decode`` defers quantization to
    ``decode``, which also appends ``noise_augment_dim`` noise
    channels."""

    def __init__(self, quantizer: DACResidualVQ,
                 quantize_on_decode: bool = False,
                 noise_augment_dim: int = 0):
        super().__init__()
        self.quantizer = quantizer
        self.quantize_on_decode = quantize_on_decode
        self.noise_augment_dim = noise_augment_dim

    def _quantize(self, x, info, n_quantizers):
        z, codes, latents, commit, cb = self.quantizer(
            x.transpose(1, -1), n_quantizers=n_quantizers)
        n = self.quantizer.n_codebooks
        info.update({"codes": codes, "latents": latents.transpose(1, -1),
                     "vq/commitment_loss": commit / n,
                     "vq/codebook_loss": cb / n})
        return z.transpose(1, -1)

    def encode(self, x, return_info=False, n_quantizers=None):
        info = {"pre_quantizer": x}
        if not self.quantize_on_decode:
            x = self._quantize(x, info, n_quantizers)
        return (x, info) if return_info else x

    def decode(self, x, generator=None, noise=None):
        if self.quantize_on_decode:
            x = self.quantizer(x.transpose(1, -1))[0].transpose(1, -1)
        if self.noise_augment_dim > 0:
            shape = (x.shape[0], self.noise_augment_dim, x.shape[-1])
            x = torch.cat([x, _normal(shape, x, generator, noise)], dim=1)
        return x

    def decode_tokens(self, codes, generator=None, noise=None):
        return self.decode(self.quantizer.from_codes(codes).transpose(1, -1),
                           generator=generator, noise=noise)


class DACRVQVAEBottleneck(DACRVQBottleneck):
    """A VAE sample of the (mean, scale) channels, then the DAC residual
    VQ; KL joins the VQ losses in info."""

    def __init__(self, quantizer: DACResidualVQ,
                 quantize_on_decode: bool = False):
        super().__init__(quantizer, quantize_on_decode)

    def encode(self, x, return_info=False, n_quantizers=None,
               generator=None, noise=None):
        mean, scale = x.chunk(2, dim=1)
        x, kl = vae_sample(mean, scale,
                           _normal(mean.shape, mean, generator, noise))
        info = {"pre_quantizer": x, "kl": kl}
        if not self.quantize_on_decode:
            x = self._quantize(x, info, n_quantizers)
        return (x, info) if return_info else x

    def decode(self, x):
        return super().decode(x)

    def decode_tokens(self, codes):
        return self.decode(self.quantizer.from_codes(codes).transpose(1, -1))
