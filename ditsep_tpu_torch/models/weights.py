"""Weight bridge between the JAX package's parameters and the port's
state_dict, both ways.

Reads and writes the flat ``.npz`` layout of ditsep_tpu/utils/checkpoint.py
(``{"a/b/c": array}``; read with or without the ``params/`` collection
wrapper and the ``backbone/`` prefix). Names follow the reference torch
names (``flax_path_to_torch_key``, a copy of ditsep_tpu/models/
torch_import.py's); leaves convert as the inverse of its ``_convert_leaf``:
conv HWIO -> OIHW, Dense (in, out) -> (out, in), GroupNorm ``scale`` ->
``weight``, NIN ``W`` and Fourier ``W`` copied as they are.
``params_to_jax`` is the inverse, by each module's type (a ``weight`` is a
GroupNorm's ``scale`` or a conv's or Dense's ``kernel``), and
``save_params_npz`` writes it, so weights trained by the port load into
both packages.
"""
from __future__ import annotations

import os

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def flax_path_to_torch_key(path: Tuple[str, ...]) -> Optional[str]:
    """Map a flax param path to the torch state_dict key; None when the
    leaf has no torch counterpart."""
    parts: List[str] = []
    for p in path[:-1]:
        if p.startswith("all_modules_"):  # all_modules_12 -> all_modules.12
            parts.extend(["all_modules", p[len("all_modules_"):]])
        else:
            parts.append(p)
    leaf_map = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "W": "W", "b": "b"}
    if path[-1] not in leaf_map:
        return None
    parts.append(leaf_map[path[-1]])
    return ".".join(parts)


def _to_torch_layout(a: np.ndarray, leaf: str) -> np.ndarray:
    if leaf == "kernel":
        if a.ndim == 4:  # conv HWIO -> OIHW
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 2:  # dense (in, out) -> (out, in)
            return a.T
        raise ValueError(f"unexpected kernel rank {a.ndim}")
    return a


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{"a/b/c": array}`` JAX parameters -> ``{torch_key: tensor}``."""
    out = {}
    for key, arr in flat.items():
        path = tuple(key.split("/"))
        if path[0] == "params":
            path = path[1:]
        tkey = flax_path_to_torch_key(path)
        if tkey is None:
            raise KeyError(f"JAX parameter {key!r} has no torch counterpart")
        a = _to_torch_layout(np.asarray(arr), path[-1])
        out[tkey] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def params_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """``model``'s parameters and buffers as the JAX package's flat
    ``{"a/b/c": array}`` parameters (``all_modules.12`` ->
    ``all_modules_12``; float32 numpy arrays in the JAX layouts)."""
    out = {}
    for key, t in model.state_dict().items():
        parts = key.split(".")
        owner = model.get_submodule(".".join(parts[:-1]))
        leaf = parts[-1]
        a = t.detach().float().cpu().numpy()
        if leaf == "weight":
            if isinstance(owner, nn.GroupNorm):
                leaf = "scale"
            elif isinstance(owner, nn.Conv2d):
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            elif isinstance(owner, nn.Linear):
                leaf, a = "kernel", a.T
            else:
                raise KeyError(f"{key}: a weight of {type(owner).__name__} "
                               "has no JAX counterpart")
        elif leaf not in ("bias", "W", "b"):
            raise KeyError(f"{key} has no JAX counterpart")
        path = []
        i = 0
        while i < len(parts) - 1:
            if parts[i] == "all_modules":
                path.append(f"all_modules_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        out["/".join(path + [leaf])] = np.ascontiguousarray(a)
    return out


def save_params_npz(path: str, model: nn.Module) -> None:
    """Write ``params_to_jax(model)`` as a flat ``.npz`` (the layout of
    ditsep_tpu/utils/checkpoint.py:save_params_npz), atomically: a
    sibling temp file renamed over the target."""
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    np.savez(tmp, **params_to_jax(model))
    os.replace(tmp, path if path.endswith(".npz") else f"{path}.npz")


def load_params_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a JAX ``.npz`` parameter export into ``model`` (strict: every
    key and shape must match). ``backbone.`` is added or stripped to fit a
    ScoreModelNCSNpp or a bare NCSNpp."""
    with np.load(path) as data:
        state = params_from_jax({k: data[k] for k in data.files})
    want = model.state_dict()
    model_prefixed = all(k.startswith("backbone.") for k in want)
    state_prefixed = all(k.startswith("backbone.") for k in state)
    if model_prefixed and not state_prefixed:
        state = {f"backbone.{k}": v for k, v in state.items()}
    elif state_prefixed and not model_prefixed:
        state = {k[len("backbone."):]: v for k, v in state.items()}
    missing = sorted(set(want) - set(state))
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        raise KeyError(f"checkpoint {path} does not fit the model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"checkpoint leaf {k!r} has shape {tuple(v.shape)}, model "
                f"expects {tuple(want[k].shape)}: wrong config for this npz")
        state[k] = v.to(want[k].dtype)
    model.load_state_dict(state, strict=True)
    return model
