"""Shared helpers of the stable-audio parity tests (tests/test_torch_{
transformer,dit,conditioners,bottleneck,generation,lm,codecs,unet1d,
dau1d}.py): flatten a flax
tree, redraw its leaves from a seed so that no zero-initialised layer hides
a difference, and carry it into a port module through
``params_from_jax``."""
import jax
import numpy as np
import torch

from ditsep_tpu_torch.models.weights import load_state, params_from_jax


def flat(tree, prefix=""):
    """A nested dict of arrays -> {"a/b/c": numpy array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, key + "/"))
        else:
            out[key] = (v if isinstance(v, jax.ShapeDtypeStruct)
                        else np.asarray(v))
    return out


def unflat(flat_tree):
    out = {}
    for key, v in flat_tree.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def init_shapes(module, *args, **kwargs):
    """A flax module's parameter tree as shapes only (``jax.eval_shape``:
    traced, not compiled or run), for ``redraw``."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kwargs))


def redraw(tree, seed: int, scale: float = 0.3):
    """Every leaf of a flax tree (arrays or shapes) drawn anew:
    N(0, scale^2 / fan_in) for kernels and tables, norm scales about 1,
    the rest N(0, scale^2 / 16); a norm's scale and a weight norm's ``g``
    about 1. Float32 numpy, the same structure."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, a in flat(tree).items():
        leaf = key.split("/")[-1]
        if leaf in ("scale", "g"):
            v = 1.0 + 0.2 * rng.standard_normal(a.shape)
        elif len(a.shape) >= 2:
            fan_in = int(np.prod(a.shape[:-1])) if leaf == "kernel" \
                else a.shape[-1]
            v = scale * rng.standard_normal(a.shape) / np.sqrt(fan_in)
        else:
            v = scale / 4 * rng.standard_normal(a.shape)
        out[key] = v.astype(np.float32)
    return unflat(out)


def load_jax(module: torch.nn.Module, jax_tree) -> torch.nn.Module:
    """Load a flax tree (with or without ``params``) into ``module``,
    strictly (each path walked through the module's ``flax_names``), and
    return it in eval mode."""
    load_state(module, params_from_jax(flat(jax_tree), module))
    return module.eval()


def max_rel(got, want) -> float:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
