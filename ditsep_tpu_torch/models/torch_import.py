"""Reference PyTorch checkpoints -> the port's modules (the port of
ditsep_tpu/models/torch_import.py:24-335).

The port's modules carry the reference's own state-dict names (the
NCSN++'s ``all_modules.{i}...``, the OobleckVAE's ``nn.Sequential``
indices and weight norm as ``weight_g`` / ``weight_v``) and layouts, so an
import is a prefix strip and a checked copy: every key of the module must
come from the checkpoint with its shape, and every checkpoint key under
the prefix must find a place, but for the reference's non-trainable
entries the port lacks (the NCSN++'s ``sigmas`` buffer). Strict mode
raises naming each key it cannot place; ``strict=False`` loads what fits.

A full DiffSep Lightning checkpoint keys the score network under
``score_model.backbone.`` and embeds torch_ema's shadow list, in the
order of the module's trainable parameters, under ``ema.shadow_params``
(reference: src/diffsep.py:578-609): ``import_diffsep_ema`` loads it.

The DAU1d and DiT importers go with their models (ROADMAP A16.3);
``utils/hub.py`` downloads, and is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from ditsep_tpu_torch.models.weights import load_state

# Non-trainable entries of the reference NCSNpp's state_dict, which
# torch_ema's shadow list skips: the ``sigmas`` buffer (reference
# src/models/diffsep/ncsnpp.py:104), which the port does not register,
# and the Gaussian Fourier projection's frozen ``W`` at all_modules.0 (a
# buffer in the port). The NIN layers' ``W`` are trainable.
_NCSNPP_NON_TRAINABLE_SUFFIXES = ("sigmas", "all_modules.0.W")


def import_params(model: nn.Module, torch_state: Mapping[str, Any],
                  prefix: str = "", strict: bool = True) -> nn.Module:
    """Load a reference NCSN++ state_dict (a flat ``{key: array or
    tensor}``) into ``model``, a ``ScoreModelNCSNpp`` or a bare ``NCSNpp``,
    and return it. ``prefix`` is stripped from every key first: '' for a
    bare NCSNpp's state_dict, ``score_model.`` or ``score_model.backbone.``
    for a full DiffSep checkpoint (``backbone.`` is added or stripped to
    fit ``model``); keys without it are ignored."""
    sub = {k[len(prefix):]: v for k, v in torch_state.items()
           if k.startswith(prefix) and not k.endswith("sigmas")}
    return load_state(model, sub, strict=strict)


def import_ema_params(model: nn.Module, shadow_params: Sequence,
                      torch_param_order: List[str], prefix: str = ""
                      ) -> nn.Module:
    """Load torch_ema's flat ``shadow_params`` list into ``model``:
    ``torch_param_order`` names each shadow's state-dict key (the
    module's trainable parameters in ``parameters()`` order); strict, as
    ``import_params``."""
    state = dict(zip(torch_param_order, shadow_params))
    return import_params(model, state, prefix=prefix, strict=True)


def diffsep_ema_param_order(state_dict_keys) -> List[str]:
    """torch ``parameters()`` order of the trainable parameters, from a
    DiffSep/NCSNpp checkpoint's state_dict key order: state_dict keeps
    registration order with the buffers and frozen parameters
    interleaved, so leaving those out gives torch_ema's shadow order."""
    return [k for k in state_dict_keys
            if not k.endswith(_NCSNPP_NON_TRAINABLE_SUFFIXES)]


def import_diffsep_ema(model: nn.Module, ckpt: Mapping[str, Any],
                       prefix: str = "score_model.backbone.") -> nn.Module:
    """Load the EMA weights of a full DiffSep Lightning checkpoint (the
    loaded object: ``ckpt['state_dict']`` and ``ckpt['ema']
    ['shadow_params']``) into ``model``. The shadows go on the trainable
    parameters under ``prefix`` in order; the frozen Fourier ``W`` and the
    buffers keep their state_dict values (torch_ema's ``copy_to``). A
    shadow count other than the trainable parameters' raises."""
    state = dict(ckpt["state_dict"])
    shadows = list(ckpt["ema"]["shadow_params"])
    order = diffsep_ema_param_order([k for k in state
                                     if k.startswith(prefix)])
    if len(order) != len(shadows):
        raise ValueError(
            f"EMA shadow list has {len(shadows)} tensors but the "
            f"checkpoint has {len(order)} trainable parameters under "
            f"{prefix!r}")
    ema_state = dict(zip(order, shadows))
    for k, v in state.items():
        ema_state.setdefault(k, v)
    return import_params(model, ema_state, prefix=prefix, strict=True)


def import_oobleck_params(vae: nn.Module, torch_state: Mapping[str, Any],
                          prefix: str = "") -> nn.Module:
    """Load a stable-audio-tools OobleckVAE state_dict (its ``encoder.`` /
    ``decoder.`` keys under ``prefix``: ``weight_g`` / ``weight_v`` of the
    weight-normed convs, ``bias``, the SnakeBeta ``alpha`` / ``beta``)
    into the port's ``OobleckVAE``, strictly; other keys (e.g. a
    bottleneck's) are ignored."""
    sub = {k[len(prefix):]: v for k, v in torch_state.items()
           if k.startswith((f"{prefix}encoder.", f"{prefix}decoder."))}
    return load_state(vae, sub)


def load_torch_ckpt(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint or state_dict file as ``{key: numpy array}``;
    a Lightning checkpoint's ``state_dict`` is unwrapped. The file is
    unpickled in full (``weights_only=False``: a Lightning checkpoint
    holds more than tensors), which runs code it names: load only files
    of a source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}
