"""Fused bias-add + leaky ReLU (+ scale), port of ditsep_tpu/ops/fused_act.py.

A CPU tensor goes to the plain PyTorch version (autograd through stock ops,
so second-order gradients work, as the JAX composite's do). A CUDA tensor
goes through ``FusedBiasActFunction``: the hand-written ``fba_fwd`` kernel
forward and ``fba_bwd`` backward (the counterpart of
``ditsep_tpu.ops.pallas_kernels.fused_bias_act_pallas``), which raises on
what the kernels do not take.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ditsep_tpu_torch.ops.cuda_kernels import (
    FusedBiasActFunction, fused_bias_act_plain,
)

Tensor = torch.Tensor


def fused_leaky_relu(x: Tensor, bias: Optional[Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = math.sqrt(2.0),
                     channel_axis: int = -1) -> Tensor:
    """out = leaky_relu(x + bias) * scale, the bias broadcast over the
    channel axis (last by default, as in JAX; 1 for NCHW). ``bias=None``
    is a zero bias."""
    if bias is None:
        bias = torch.zeros(x.shape[channel_axis], dtype=x.dtype,
                           device=x.device)
    if x.device.type == "cpu":
        return fused_bias_act_plain(x, bias, negative_slope, scale,
                                    channel_axis)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu runs on the CPU or CUDA, got "
                         f"{x.device}")
    return FusedBiasActFunction.apply(x, bias, negative_slope, scale,
                                      channel_axis)
