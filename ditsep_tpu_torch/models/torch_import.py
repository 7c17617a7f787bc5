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

``import_dit_params`` loads a stable-audio DiffusionTransformer
state_dict (port of ditsep_tpu/models/torch_import.py:417-520) by a
rename to the port's flax names. ``import_dau1d_params`` loads a
dance-diffusion DiffusionAttnUnet1D state_dict (port of
ditsep_tpu/models/torch_import.py:337-415) through the JAX package's own
key map into the flax layout, then ``params_from_jax``;
``dau1d_reference_state`` is its inverse. ``utils/hub.py`` downloads, and
is not ported.
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


# the reference DiT's non-trainable entries the port does not keep: the
# rotary embedding's frequency buffer (built from the config)
_DIT_SKIPPED_SUFFIXES = ("rotary_pos_emb.inv_freq",)


def dit_reference_key(key: str) -> str:
    """A reference DiffusionTransformer state_dict key (reference:
    stable-audio-tools models/dit.py:12-180, continuous_transformer,
    models/transformer.py:637-899) -> the port's key: the MLPs' ``.0`` /
    ``.2`` are ``dense_0`` / ``dense_1``, ``transformer.layers.{i}`` is
    ``transformer.layer_{i}``, the adaLN ``global_cond_embedder.0`` / ``.2``
    are ``global_embed_in`` / ``global_embed_out``, the GLU's
    ``ff.ff.0.proj`` / ``ff.ff.2`` are ``ff.proj_in`` / ``ff.proj_out``, a
    LayerNorm's ``gamma`` / ``beta`` its ``weight`` / ``bias``."""
    parts = key.split(".")
    if parts[0] in ("to_timestep_embed", "to_cond_embed", "to_global_embed",
                    "to_prepend_embed") and len(parts) == 3:
        return f"{parts[0]}.dense_{int(parts[1]) // 2}.{parts[2]}"
    if parts[:2] == ["transformer", "global_cond_embedder"]:
        which = {"0": "global_embed_in", "2": "global_embed_out"}[parts[2]]
        return f"transformer.{which}.{parts[3]}"
    if parts[:2] == ["transformer", "layers"]:
        rest = ".".join(parts[3:])
        rest = (rest.replace("ff.ff.0.proj.", "ff.proj_in.")
                .replace("ff.ff.2.", "ff.proj_out."))
        if rest.endswith(".gamma"):
            rest = rest[:-len("gamma")] + "weight"
        elif rest.endswith(".beta"):
            rest = rest[:-len("beta")] + "bias"
        return f"transformer.layer_{parts[2]}.{rest}"
    return key


def import_dit_params(model: nn.Module, state_dict: Mapping[str, Any],
                      prefix: str = "") -> nn.Module:
    """Load a reference DiffusionTransformer state_dict (the keys under
    ``prefix``: ``model.model.`` in a stable-audio-tools
    ``ConditionedDiffusionModelWrapper`` checkpoint) into the port's
    ``DiffusionTransformer``, strictly, and return it. A LayerNorm without
    its ``beta`` buffer takes a zero bias, as the reference keeps it; the
    rotary frequency buffer is skipped."""
    sub = {dit_reference_key(k[len(prefix):]): v
           for k, v in state_dict.items()
           if k.startswith(prefix) and not k.endswith(_DIT_SKIPPED_SUFFIXES)}
    for key, value in model.state_dict().items():
        if key.endswith("norm.bias") and key not in sub:
            sub[key] = torch.zeros_like(value)
    return load_state(model, sub)


def dit_reference_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of ``import_dit_params``: a port DiffusionTransformer's
    parameters as a reference state_dict (``dense_{0,1}`` -> ``.0`` /
    ``.2``, ``layer_{i}`` -> ``layers.{i}``, the block norms' ``gamma`` /
    ``beta``, the GLU's ``ff.ff.0.proj`` / ``ff.ff.2``)."""
    out = {}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        if parts[0].startswith("to_") and parts[1].startswith("dense_"):
            key = f"{parts[0]}.{2 * int(parts[1][6:])}.{parts[2]}"
        elif parts[:2] in (["transformer", "global_embed_in"],
                           ["transformer", "global_embed_out"]):
            which = 0 if parts[1] == "global_embed_in" else 2
            key = f"transformer.global_cond_embedder.{which}.{parts[2]}"
        elif parts[0] == "transformer" and parts[1].startswith("layer_"):
            rest = ".".join(parts[2:])
            rest = (rest.replace("ff.proj_in.", "ff.ff.0.proj.")
                    .replace("ff.proj_out.", "ff.ff.2."))
            if parts[2] in ("pre_norm", "ff_norm", "cross_attend_norm"):
                leaf = "gamma" if parts[3] == "weight" else "beta"
                rest = f"{parts[2]}.{leaf}"
            key = f"transformer.layers.{parts[1][6:]}.{rest}"
        out[key] = value.detach().clone()
    return out


# -------------------------------------------------------------------------
# DAU1d (dance-diffusion DiffusionAttnUnet1D)
# -------------------------------------------------------------------------
# SkipBlock.main of the reference: [down, conv, attn, conv, attn, conv,
# attn, inner, conv, attn, conv, attn, conv, attn, up]
_DAU_CONVS = (("pre0", 1), ("pre1", 3), ("pre2", 5), ("post0", 8),
              ("post1", 10), ("post2", 12))
_DAU_ATTNS = (("attn0", 2), ("attn1", 4), ("attn2", 6), ("attn3", 9),
              ("attn4", 11), ("attn5", 13))
_DAU_TOP = (("stem0", "net.0"), ("stem1", "net.1"), ("stem2", "net.2"),
            ("head0", "net.4"), ("head1", "net.5"), ("head2", "net.6"))
# a ResConvBlock's main: [conv, GroupNorm, GELU, conv, GroupNorm, GELU]
_DAU_RES = (("conv1/kernel", "main.0.weight"), ("conv1/bias", "main.0.bias"),
            ("norm1/scale", "main.1.weight"), ("norm1/bias", "main.1.bias"),
            ("conv2/kernel", "main.3.weight"), ("conv2/bias", "main.3.bias"),
            ("norm2/scale", "main.4.weight"), ("norm2/bias", "main.4.bias"),
            ("skip/kernel", "skip.weight"))
_DAU_ATTN = (("norm/scale", "norm.weight"), ("norm/bias", "norm.bias"),
             ("qkv_proj/kernel", "qkv_proj.weight"),
             ("qkv_proj/bias", "qkv_proj.bias"),
             ("out_proj/kernel", "out_proj.weight"),
             ("out_proj/bias", "out_proj.bias"))


def _dau1d_key_map(model: nn.Module) -> Dict[str, str]:
    """Every flax path of ``model`` (a DiffusionAttnUnet1D) that the JAX
    importer may fill -> its reference key (the learned ``down`` / ``up``
    where the reference has them)."""
    out = {"timestep_embed": "timestep_embed.weight"}
    for name, ref in _DAU_TOP:
        out.update({f"{name}/{f}": f"{ref}.{r}" for f, r in _DAU_RES})
    level, prefix, ref = getattr(model, "inner", None), "inner", "net.3.main"
    while level is not None:
        for name, idx in _DAU_CONVS:
            out.update({f"{prefix}/{name}/{f}": f"{ref}.{idx}.{r}"
                        for f, r in _DAU_RES})
        if not isinstance(level.attn0, nn.Identity):
            for name, idx in _DAU_ATTNS:
                out.update({f"{prefix}/{name}/{f}": f"{ref}.{idx}.{r}"
                            for f, r in _DAU_ATTN})
        for leaf, tleaf in (("kernel", "weight"), ("bias", "bias")):
            out[f"{prefix}/down/{leaf}"] = f"{ref}.0.{tleaf}"
            out[f"{prefix}/up/{leaf}"] = f"{ref}.14.{tleaf}"
        level = getattr(level, "inner", None)
        prefix, ref = f"{prefix}/inner", f"{ref}.7.main"
    return out


def import_dau1d_params(model: nn.Module, state_dict: Mapping[str, Any]
                        ) -> nn.Module:
    """Load a reference DiffusionAttnUnet1D state_dict into the port's
    ``DiffusionAttnUnet1D``, strictly, and return it: each key mapped as
    the JAX package's importer maps it (conv weights (out, in, k) to flax
    (k, in, out)), then ``params_from_jax``. FIR resampling has no
    parameters; learned resampling convs load where present."""
    from ditsep_tpu_torch.models.weights import params_from_jax

    flat = {}
    for path, ref in _dau1d_key_map(model).items():
        if ref in state_dict:
            a = state_dict[ref]
            a = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                 else np.asarray(a))
            flat[path] = a.transpose(2, 1, 0) if path.endswith(
                "kernel") else a
    return load_state(model, params_from_jax(flat, model))


def dau1d_reference_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The inverse of ``import_dau1d_params``: the port's parameters as a
    reference DiffusionAttnUnet1D state_dict."""
    from ditsep_tpu_torch.models.weights import params_to_jax

    flat, keys = params_to_jax(model), _dau1d_key_map(model)
    missing = sorted(set(flat) - set(keys))
    if missing:
        raise KeyError(f"parameters without a reference key: {missing}")
    return {keys[p]: torch.from_numpy(np.ascontiguousarray(
        a.transpose(2, 1, 0) if p.endswith("kernel") else a))
        for p, a in flat.items()}
