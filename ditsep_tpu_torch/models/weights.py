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
GroupNorm's ``scale`` or a conv's or Dense's ``kernel``; for a bare
state_dict, by the leaf's rank: 1-D, 4-D, 2-D), and ``save_params_npz``
writes it, so weights trained by the port load into both packages.

The stable-audio models (the DiT, the conditioners, the residual VQs)
carry the flax names themselves, so the same rule covers them, with three
more leaves: a conv1d kernel WIO (1, in, out) <-> OIW (out, in, 1), an
``Embed``'s ``embedding`` <-> ``nn.Embedding.weight``, and any other leaf
(``to_scale_shift_gate``, LayerScale's ``gamma``, ``codebook_{q}``, the
Fourier features' ``weight``) copied under its own name. A ``params``
level anywhere in a path (a conditioner's variables under its name) is
dropped.

Given the ``model``, ``params_from_jax(flat, model)`` walks its module
tree beside each flax path, so a module may name its children otherwise
than flax: a module's ``flax_names`` maps a flax child name to its own
(dotted) path. The Oobleck blocks reused by the codecs do so (their
reference ``nn.Sequential`` layout: ``res_0`` -> ``layers.0``, ``down`` ->
``layers.4``, ``act_0`` -> ``layers.0.act``...). A weight-normed conv's
``v`` / ``g`` become ``weight_v`` (WIO (k, in, out) <-> (out, in, k), a
transposed conv's (k, out, in) <-> (in, out, k)) and ``weight_g`` ((n,)
<-> (n, 1, 1)), a 2-D one's (the discriminators') HWIO <-> OIHW and (n,)
<-> (n, 1, 1, 1); SnakeBeta's ``alpha`` / ``beta``, the DAU1d's
``timestep_embed`` and ``snake_a_{c}`` keep their names.
``params_to_jax(model)`` walks the same way back.

The OobleckVAE has a bridge of its own (``oobleck_params_from_jax`` /
``oobleck_params_to_jax``, a copy of ditsep_tpu/models/torch_import.py:
151-205's key map and its inverse): the flax tree (``encoder/stem/v``,
``encoder/block_i/res_j/conv_k/g``, SnakeBeta ``alpha`` / ``beta``)
against the reference's ``nn.Sequential`` keys, ``v`` WIO (k, in, out) <->
(out, in, k) (a transposed conv's (k, out, in) <-> (in, out, k)) and ``g``
(n,) <-> (n, 1, 1). ``load_params_npz`` and ``save_params_npz`` take it for
an OobleckVAE.

The Encodec discriminator's bridge (``disc_params_{from,to}_jax``) maps
the flax tree ``disc_{i}/conv_{j}/{v,g,bias}`` (``conv_post`` the last)
to ``discs.{i}.convs.{j}.weight_v`` / ``weight_g`` / ``bias``
(``discs.{i}.conv_post...``): ``v`` HWIO <-> OIHW, ``g`` (n,) <-> (n, 1,
1, 1).
"""
from __future__ import annotations

import os
import re

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ditsep_tpu_torch.models.oobleck import OobleckVAE


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
        if a.ndim == 3:  # conv1d WIO -> OIW
            return a.transpose(2, 1, 0)
        if a.ndim == 2:  # dense (in, out) -> (out, in)
            return a.T
        raise ValueError(f"unexpected kernel rank {a.ndim}")
    return a


# flax leaves outside ``flax_path_to_torch_key``'s map that keep a name of
# their own in the port (the stable-audio models')
_OWN_NAME_LEAVES = ("to_scale_shift_gate", "gamma", "weight", "alpha",
                    "beta", "timestep_embed")
_OWN_NAME_PREFIXES = ("codebook_", "snake_a_")
# a weight-normed conv's flax leaves and the port's
_WN_LEAVES = {"v": "weight_v", "g": "weight_g", "bias": "bias"}


def _own_name(leaf: str) -> bool:
    return leaf in _OWN_NAME_LEAVES or leaf.startswith(_OWN_NAME_PREFIXES)


def _torch_key(path: Tuple[str, ...]) -> Optional[str]:
    tkey = flax_path_to_torch_key(path)
    if tkey is not None:
        return tkey
    leaf = path[-1]
    if leaf == "embedding":
        leaf = "weight"
    elif not _own_name(leaf):
        return None
    return ".".join(path[:-1] + (leaf,))


def _flax_names(module: nn.Module) -> Dict[str, str]:
    return getattr(module, "flax_names", None) or {}


def _is_wn_conv(module: nn.Module) -> bool:
    from ditsep_tpu_torch.models.discriminators import WNConv2d
    from ditsep_tpu_torch.models.oobleck import WNConv1d, WNConvTranspose1d
    return isinstance(module, (WNConv1d, WNConvTranspose1d, WNConv2d))


def _wn_v_to_torch(a: np.ndarray) -> np.ndarray:
    """A weight-normed conv's flax ``v`` (k, in, out) / HWIO -> the port's
    (out, in, k) / OIHW (a transposed conv's (k, out, in) -> (in, out,
    k))."""
    return a.transpose(2, 1, 0) if a.ndim == 3 else a.transpose(3, 2, 0, 1)


def _wn_v_to_jax(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 1, 0) if a.ndim == 3 else a.transpose(2, 3, 1, 0)


def _walk_from_jax(model: nn.Module, path: Tuple[str, ...], key: str):
    """A flax path (without its leaf) -> (the module's dotted path, the
    module), through each module's ``flax_names``; an NCSN++'s
    ``all_modules_i`` is ``all_modules.i``. A tree with or without the
    score model's ``backbone`` walks from the model's backbone or past the
    tree's (``load_state`` adds or strips the prefix). A segment that names
    no submodule raises, naming the parameter's ``key``."""
    mod, parts = model, []
    first = _flax_names(model).get(path[0], path[0]) if path else None
    if path and not hasattr(model, first.split(".")[0]):
        if path[0] == "backbone":
            path = path[1:]
        elif isinstance(getattr(model, "backbone", None), nn.Module):
            mod = model.backbone
    for p in path:
        name = _flax_names(mod).get(p, p)
        if re.fullmatch(r"all_modules_\d+", name):
            name = "all_modules." + name[len("all_modules_"):]
        try:
            mod = mod.get_submodule(name)
        except AttributeError as e:
            raise KeyError(f"JAX parameter {key!r}: {type(mod).__name__} "
                           f"has no submodule {name!r}") from e
        parts.append(name)
    return parts, mod


def params_from_jax(flat: Mapping[str, np.ndarray],
                    model: Optional[nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """``{"a/b/c": array}`` JAX parameters -> ``{torch_key: tensor}``.
    Given ``model``, each path is walked through its modules (their
    ``flax_names``; weight-normed convs' ``v`` / ``g``). Without one, an
    OobleckVAE's tree (every key under ``encoder/`` or ``decoder/``) goes
    through ``oobleck_params_from_jax``, as with an OobleckVAE ``model``."""
    paths = {key: tuple(p for p in key.split("/") if p != "params")
             for key in flat}
    if isinstance(model, OobleckVAE) or (model is None and paths and all(
            p[0] in ("encoder", "decoder") for p in paths.values())):
        return oobleck_params_from_jax(flat)
    out = {}
    for key, arr in flat.items():
        path, a = paths[key], np.asarray(arr)
        parts, owner = path[:-1], None
        if model is not None:
            parts, owner = _walk_from_jax(model, path[:-1], key)
        if owner is not None and _is_wn_conv(owner):
            leaf = _WN_LEAVES.get(path[-1])
            tkey = None if leaf is None else ".".join(parts + [leaf])
            if path[-1] == "v":
                a = _wn_v_to_torch(a)
            elif path[-1] == "g":
                a = a.reshape((-1,) + (1,) * (owner.weight_v.ndim - 1))
        else:
            tkey = _torch_key(tuple(parts) + path[-1:])
            a = _to_torch_layout(a, path[-1])
        if tkey is None:
            raise KeyError(f"JAX parameter {key!r} has no torch counterpart")
        out[tkey] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _weight_kinds():
    """The modules whose ``weight`` has a JAX counterpart, and its kind
    there."""
    from ditsep_tpu_torch.models.dit import FourierFeatures
    from ditsep_tpu_torch.models.transformer import LayerNorm
    return ((nn.GroupNorm, "scale"), (LayerNorm, "scale"),
            (nn.Conv2d, "conv"), (nn.Conv1d, "conv1d"),
            (nn.Linear, "dense"), (nn.Embedding, "embedding"),
            (FourierFeatures, "own"))


def params_to_jax(model) -> Dict[str, np.ndarray]:
    """A model's parameters and buffers, the module or its ``state_dict``,
    as the JAX package's flat ``{"a/b/c": array}`` parameters
    (``all_modules.12`` -> ``all_modules_12``; float32 numpy arrays in the
    JAX layouts): a score model's, an NCSN++'s, or a stable-audio model's
    (the module only; an OobleckVAE's through ``oobleck_params_to_jax``).
    A module's weights are named by their owner's type; a state_dict's,
    which has no modules, by their rank."""
    if isinstance(model, OobleckVAE):
        return oobleck_params_to_jax(model)
    module = model if isinstance(model, nn.Module) else None
    state = model.state_dict() if module is not None else model
    out = {}
    for key, t in state.items():
        parts = key.split(".")
        leaf = parts[-1]
        a = t.detach().float().cpu().numpy()
        if module is not None:
            path, owner = _walk_to_jax(module, parts[:-1])
            if _is_wn_conv(owner):
                wn = {v: k for k, v in _WN_LEAVES.items()}
                if leaf == "weight_v":
                    a = _wn_v_to_jax(a)
                elif leaf == "weight_g":
                    a = a.reshape(-1)
                out["/".join(path + [wn[leaf]])] = np.ascontiguousarray(a)
                continue
        if leaf == "weight":
            if module is not None:
                kind = next((k for cls, k in _weight_kinds()
                             if isinstance(owner, cls)), None)
                what = f"a weight of {type(owner).__name__}"
            else:
                kind = {1: "scale", 4: "conv", 2: "dense"}.get(a.ndim)
                what = f"a {a.ndim}-D weight"
            if kind is None:
                raise KeyError(f"{key}: {what} has no JAX counterpart")
            if kind == "scale":  # GroupNorm, LayerNorm
                leaf = "scale"
            elif kind == "conv":  # OIHW -> HWIO
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif kind == "conv1d":  # OIW -> WIO
                leaf, a = "kernel", a.transpose(2, 1, 0)
            elif kind == "embedding":
                leaf = "embedding"
            elif kind == "dense":
                leaf, a = "kernel", a.T
        elif not (leaf in ("bias", "W", "b")
                  or (module is not None and _own_name(leaf))):
            raise KeyError(f"{key} has no JAX counterpart")
        if module is None:
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


def _walk_to_jax(model: nn.Module, parts: List[str]):
    """A module's dotted path -> (its flax path, the module): at each
    module the longest run of parts that its ``flax_names`` gives a flax
    name takes that name; ``all_modules.{i}`` is ``all_modules_{i}``."""
    mod, path, i = model, [], 0
    while i < len(parts):
        inv = {v: k for k, v in _flax_names(mod).items()}
        for j in range(len(parts), i, -1):
            if ".".join(parts[i:j]) in inv:
                path.append(inv[".".join(parts[i:j])])
                mod = mod.get_submodule(".".join(parts[i:j]))
                i = j
                break
        else:
            if parts[i] == "all_modules":
                path.append(f"all_modules_{parts[i + 1]}")
                mod = mod.get_submodule(f"all_modules.{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                mod = mod.get_submodule(parts[i])
                i += 1
    return path, mod


def save_params_npz(path: str, model) -> None:
    """Write ``params_to_jax(model)`` (``oobleck_params_to_jax`` for an
    OobleckVAE; a score model's ``state_dict`` goes as it is) as a flat
    ``.npz`` (the layout of ditsep_tpu/utils/checkpoint.py:
    save_params_npz), atomically: a sibling temp file renamed over the
    target."""
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    flat = (oobleck_params_to_jax(model) if isinstance(model, OobleckVAE)
            else params_to_jax(model))
    np.savez(tmp, **flat)
    os.replace(tmp, path if path.endswith(".npz") else f"{path}.npz")


def load_params_npz(path: str, model: nn.Module) -> nn.Module:
    """Load a JAX ``.npz`` parameter export into ``model`` (strict: every
    key and shape must match). ``backbone.`` is added or stripped to fit a
    score model or a bare NCSNpp; an OobleckVAE reads the VAE's tree."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return load_state(model, params_from_jax(flat, model),
                      source=f"checkpoint {path}")


def load_state(model: nn.Module, state: Mapping, *, strict: bool = True,
               source: str = "the checkpoint") -> nn.Module:
    """Copy ``state`` ({state_dict key: tensor or array}) into ``model``
    and return it: ``backbone.`` added or stripped to fit a score model or
    a bare NCSNpp, every shape checked, each value cast to the model's
    dtype. ``strict``: every key on both sides must be placed (a KeyError
    names those that are not); otherwise what fits is loaded and the rest
    keeps its values."""
    want = model.state_dict()
    model_prefixed = bool(want) and all(k.startswith("backbone.")
                                        for k in want)
    state_prefixed = bool(state) and all(k.startswith("backbone.")
                                         for k in state)
    if model_prefixed and not state_prefixed:
        state = {f"backbone.{k}": v for k, v in state.items()}
    elif state_prefixed and not model_prefixed:
        state = {k[len("backbone."):]: v for k, v in state.items()}
    missing = [k for k in want if k not in state]
    unexpected = [k for k in state if k not in want]
    if strict and (missing or unexpected):
        raise KeyError(f"{source} does not fit the model: missing {missing}, "
                       f"no place for {unexpected}")
    new = {}
    for k, v in state.items():
        if k not in want:
            continue
        t = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(
                f"{source}: leaf {k!r} has shape {tuple(t.shape)}, the model "
                f"expects {tuple(want[k].shape)} (a wrong config for it?)")
        new[k] = t.to(want[k].dtype)
    model.load_state_dict({**want, **new}, strict=True)
    return model


# -------------------------------------------------------------- OobleckVAE --
_OOBLECK_LEAVES = {"v": "weight_v", "g": "weight_g", "bias": "bias",
                   "alpha": "alpha", "beta": "beta"}
# ResidualUnit.layers: 0 act, 1 conv k=7, 2 act, 3 conv k=1
_RES_LOCAL = {"conv_0": "layers.1", "conv_1": "layers.3",
              "act_0": "layers.0.act", "act_1": "layers.2.act"}


def oobleck_flax_path_to_torch_key(path: Tuple[str, ...],
                                   n_blocks: int = 5) -> Optional[str]:
    """An OobleckVAE flax parameter path -> the reference state_dict key
    (EncoderBlock.layers: 0-2 residual units, 3 act, 4 down; DecoderBlock:
    0 act, 1 up, 2-4 residual units; the stem at 0, the blocks at 1..n,
    the top act at n + 1, the head at n + 2). None when unmapped."""
    parts = list(path)
    leaf = parts.pop()
    if leaf not in _OOBLECK_LEAVES or len(parts) < 2:
        return None
    side, rest = parts[0], parts[1:]
    out = [side]
    if rest[0] == "stem":
        out.append("layers.0")
    elif rest[0] == "head":
        out.append(f"layers.{n_blocks + 2}")
    elif rest[0] == "act":
        out.append(f"layers.{n_blocks + 1}.act")
    elif rest[0].startswith("block_") and len(rest) >= 2:
        out.append(f"layers.{int(rest[0][6:]) + 1}")
        if rest[1].startswith("res_") and len(rest) == 3:
            r = int(rest[1][4:])
            out += [f"layers.{r if side == 'encoder' else 2 + r}",
                    _RES_LOCAL[rest[2]]]
        elif side == "encoder" and rest[1] in ("down", "act"):
            out.append({"down": "layers.4", "act": "layers.3.act"}[rest[1]])
        elif side == "decoder" and rest[1] in ("up", "act"):
            out.append({"up": "layers.1", "act": "layers.0.act"}[rest[1]])
        else:
            return None
    else:
        return None
    out.append(_OOBLECK_LEAVES[leaf])
    return ".".join(out)


def oobleck_torch_key_to_flax_path(key: str, n_blocks: int) -> str:
    """The inverse of ``oobleck_flax_path_to_torch_key``, as "a/b/c"."""
    leaves = {v: k for k, v in _OOBLECK_LEAVES.items()}
    res_local = {v: k for k, v in _RES_LOCAL.items()}
    parts = key.split(".")
    side, idx, rest, leaf = parts[0], int(parts[2]), parts[3:-1], parts[-1]
    if parts[1] != "layers" or leaf not in leaves:
        raise KeyError(f"{key} is not an OobleckVAE key")
    if idx == 0:
        path = ["stem"]
    elif idx == n_blocks + 2:
        path = ["head"]
    elif idx == n_blocks + 1:
        path = ["act"]
    else:
        path = [f"block_{idx - 1}"]
        sub = int(rest[1])
        if side == "encoder":
            named = {3: "act", 4: "down"}
            first_res = 0
        else:
            named = {0: "act", 1: "up"}
            first_res = 2
        if sub in named:
            path.append(named[sub])
        else:
            path += [f"res_{sub - first_res}",
                     res_local[".".join(rest[2:])]]
    return "/".join([side, *path, leaves[leaf]])


def _oobleck_n_blocks(keys) -> int:
    """The block count of a flat VAE tree (or of a lone encoder's or
    decoder's)."""
    return max(len({k.split("/")[1] for k in keys
                    if k.startswith(f"{side}/block_")})
               for side in ("encoder", "decoder"))


def oobleck_params_from_jax(flat: Mapping[str, np.ndarray]
                            ) -> Dict[str, torch.Tensor]:
    """``{"encoder/stem/v": array, ...}`` OobleckVAE parameters (with or
    without ``params/``) -> the reference state_dict."""
    flat = {(k[len("params/"):] if k.startswith("params/") else k): v
            for k, v in flat.items()}
    n_blocks = _oobleck_n_blocks(flat)
    out = {}
    for key, arr in flat.items():
        tkey = oobleck_flax_path_to_torch_key(tuple(key.split("/")),
                                              n_blocks)
        if tkey is None:
            raise KeyError(f"OobleckVAE parameter {key!r} has no torch "
                           "counterpart")
        a = np.asarray(arr)
        if key.endswith("/v"):
            a = a.transpose(2, 1, 0)
        elif key.endswith("/g"):
            a = a.reshape(-1, 1, 1)
        out[tkey] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def oobleck_params_to_jax(vae: nn.Module) -> Dict[str, np.ndarray]:
    """An OobleckVAE's parameters as the JAX package's flat tree (float32
    numpy arrays in the flax layouts)."""
    n_blocks = len(vae.strides)
    out = {}
    for key, t in vae.state_dict().items():
        a = t.detach().float().cpu().numpy()
        if key.endswith("weight_v"):
            a = a.transpose(2, 1, 0)
        elif key.endswith("weight_g"):
            a = a.reshape(-1)
        out[oobleck_torch_key_to_flax_path(key, n_blocks)] = (
            np.ascontiguousarray(a))
    return out


# ------------------------------------------- MultiScaleSTFTDiscriminator --
_DISC_LEAVES = {"v": "weight_v", "g": "weight_g", "bias": "bias"}


def _disc_torch_key(path: str) -> str:
    """``disc_i/conv_j/leaf`` (or ``conv_post``) -> ``discs.i.convs.j.
    weight_v`` (``discs.i.conv_post...``)."""
    disc, conv, leaf = path.split("/")
    if not disc.startswith("disc_") or leaf not in _DISC_LEAVES:
        raise KeyError(f"{path!r} is not a discriminator parameter")
    mod = "conv_post" if conv == "conv_post" else f"convs.{int(conv[5:])}"
    return f"discs.{int(disc[5:])}.{mod}.{_DISC_LEAVES[leaf]}"


def disc_params_from_jax(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's MultiScaleSTFTDiscriminator tree (flat, with or
    without ``params/``) -> the port's state_dict: ``v`` HWIO -> OIHW,
    ``g`` (out,) -> (out, 1, 1, 1)."""
    out = {}
    for key, arr in flat.items():
        key = key[len("params/"):] if key.startswith("params/") else key
        a = np.asarray(arr)
        if key.endswith("/v"):
            a = a.transpose(3, 2, 0, 1)
        elif key.endswith("/g"):
            a = a.reshape(-1, 1, 1, 1)
        out[_disc_torch_key(key)] = torch.from_numpy(np.array(a))
    return out


def disc_params_to_jax(disc: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``disc_params_from_jax``: the flat JAX tree."""
    leaves = {v: k for k, v in _DISC_LEAVES.items()}
    out = {}
    for key, t in disc.state_dict().items():
        parts = key.split(".")  # discs.i.convs.j.leaf / discs.i.conv_post.leaf
        conv = "conv_post" if parts[2] == "conv_post" else f"conv_{parts[3]}"
        a = t.detach().float().cpu().numpy()
        if parts[-1] == "weight_v":
            a = a.transpose(2, 3, 1, 0)
        elif parts[-1] == "weight_g":
            a = a.reshape(-1)
        out[f"disc_{parts[1]}/{conv}/{leaves[parts[-1]]}"] = (
            np.ascontiguousarray(a))
    return out
