"""Normalization layers: the TasNet gLN / cLN and the conditional instance
norms of the legacy NCSN stack (port of ditsep_tpu/models/normalization.py;
reference: src/models/diffsep/tcn.py choose_norm / ChannelwiseLayerNorm /
GlobalLayerNorm and ncsnpp_utils/normalization.py:22-243).

The 1-D norms take the JAX package's channel-last (B, T, C); the 2-D
instance norms the port's NCHW (the JAX package's are NHWC). Parameters
carry the flax names (``gamma``, ``beta``, ``alpha``, ``embed``), so
``models.weights.params_from_jax`` loads a JAX tree. Where flax infers the
channel count from the input, the port's constructors take it.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ditsep_tpu_torch.models.layers import GroupNorm
from ditsep_tpu_torch.models.transformer import LayerNorm

Tensor = torch.Tensor


def _moments(x: Tensor, dims):
    mean = x.mean(dim=dims, keepdim=True)
    var = (x - mean).square().mean(dim=dims, keepdim=True)
    return mean, var


class ChannelwiseLayerNorm(nn.Module):
    """cLN: normalize over the channel (last) axis at each time step."""

    def __init__(self, channels: int, eps: float = 1e-8):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.gamma)
        nn.init.zeros_(self.beta)

    def forward(self, x: Tensor) -> Tensor:
        mean, var = _moments(x, -1)
        return self.gamma * (x - mean) / torch.sqrt(var + self.eps) + self.beta


class GlobalLayerNorm(ChannelwiseLayerNorm):
    """gLN: normalize over every axis but the batch's, jointly."""

    def forward(self, x: Tensor) -> Tensor:
        mean, var = _moments(x, tuple(range(1, x.ndim)))
        return self.gamma * (x - mean) / torch.sqrt(var + self.eps) + self.beta


def choose_norm(norm_type: str, channels: int) -> nn.Module:
    """'gLN' | 'cLN' | 'BN' (flax's LayerNorm over the channels, as the
    JAX package substitutes it)."""
    if norm_type == "gLN":
        return GlobalLayerNorm(channels)
    if norm_type == "cLN":
        return ChannelwiseLayerNorm(channels)
    if norm_type == "BN":
        return LayerNorm(channels)
    raise ValueError(f"unsupported norm type {norm_type}")


def _instance_stats(x: Tensor):
    """Per (item, channel) mean and population std over H, W of NCHW x;
    the channel means normalized across channels."""
    means = x.mean(dim=(2, 3), keepdim=True)                 # (B, C, 1, 1)
    m = means.mean(dim=1, keepdim=True)
    v = means.std(dim=1, keepdim=True, unbiased=False)
    means_norm = (means - m) / (v + 1e-5)
    inst = (x - means) / (x.std(dim=(2, 3), keepdim=True, unbiased=False)
                          + 1e-5)
    return inst, means_norm


class ConditionalInstanceNorm2dPlus(nn.Module):
    """Class-conditional instance norm with the channel means reinjected:
    ``forward(x (B, C, H, W), y (B,) int labels)``; ``embed`` gives gamma,
    alpha (and beta) around 1 (and 0)."""

    def __init__(self, num_features: int, num_classes: int,
                 bias: bool = True):
        super().__init__()
        self.bias = bias
        self.embed = nn.Embedding(num_classes,
                                  (3 if bias else 2) * num_features)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        inst, means_norm = _instance_stats(x)
        emb = self.embed(y)
        if self.bias:
            gamma, alpha, beta = emb.chunk(3, dim=-1)
        else:
            gamma, alpha = emb.chunk(2, dim=-1)
        gamma, alpha = 1.0 + gamma[:, :, None, None], 1.0 + alpha
        out = gamma * inst + means_norm * alpha[:, :, None, None]
        if self.bias:
            out = out + beta[:, :, None, None]
        return out


class InstanceNorm2dPlus(nn.Module):
    """The unconditional variant over NCHW: gamma and alpha (N(0, 0.02^2)
    around 1) and beta (zeros) per channel."""

    def __init__(self, num_features: int, bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features))
        self.gamma = nn.Parameter(torch.empty(num_features))
        if bias:
            self.beta = nn.Parameter(torch.zeros(num_features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.alpha.normal_(0.0, 0.02, generator=generator)
            self.gamma.normal_(0.0, 0.02, generator=generator)
            if hasattr(self, "beta"):
                self.beta.zero_()

    def forward(self, x: Tensor) -> Tensor:
        inst, means_norm = _instance_stats(x)
        c = (1, -1, 1, 1)
        out = ((self.gamma + 1.0).reshape(c) * inst
               + means_norm * (self.alpha + 1.0).reshape(c))
        if hasattr(self, "beta"):
            out = out + self.beta.reshape(c)
        return out


def get_normalization(norm: str = "InstanceNorm++", conditional: bool = False,
                      num_classes: int = 10):
    """A constructor of the named norm, called with the channel count
    (``num_features``) and the JAX constructor's keywords: InstanceNorm++
    (conditional on ``num_classes`` labels or not) or GroupNorm
    (``num_groups``, ``epsilon``; flax's defaults 32 and 1e-6)."""
    if norm == "InstanceNorm++":
        if conditional:
            return lambda num_features, **kw: ConditionalInstanceNorm2dPlus(
                num_features, num_classes=num_classes, **kw)
        return lambda num_features, **kw: InstanceNorm2dPlus(num_features,
                                                             **kw)
    if norm == "GroupNorm":
        return lambda num_features, num_groups=32, epsilon=1e-6: GroupNorm(
            num_groups, num_features, eps=epsilon)
    raise NotImplementedError(f"{norm} not implemented")
