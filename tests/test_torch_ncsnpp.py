"""The port's NCSN++ (ditsep_tpu_torch.models.NCSNpp) against the JAX one.

JAX-initialised weights are carried over by ``params_from_jax``; inputs are
numpy arrays from a seed. Tolerance 2e-5 * max|ref|, the JAX package's own
NCSN++ bar against the original torch model (PARITY.md section 2.2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from ditsep_tpu.models import NCSNpp as JaxNCSNpp
from ditsep_tpu.models.torch_import import import_params
from ditsep_tpu_torch.models import NCSNpp, params_from_jax

CFG = dict(nf=16, ch_mult=(1, 1, 1), num_res_blocks=1, attn_resolutions=(8,),
           image_size=32, num_channels_in=6, num_channels_out=4)
TOL = 2e-5


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.array(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _jax_model_and_params(perturb: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    model = JaxNCSNpp(**CFG)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 32, 16, 6)),
                                 jnp.full((1,), 0.5))["params"]
    flat = _flat(params)
    if perturb:  # the zero-scaled init (init_scale 0) hides whole branches
        flat = {k: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype)
                for k, a in flat.items()}
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(a)
                           for k, a in flat.items()})
    return model, tree, flat


@pytest.mark.parametrize("perturb", [False, True],
                         ids=["jax_init", "perturbed"])
def test_ncsnpp_matches_jax(perturb):
    jm, params, flat = _jax_model_and_params(perturb)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 16, 6)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                               jnp.asarray(t)))
    model = NCSNpp(**CFG).eval()
    model.load_state_dict(params_from_jax(flat), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                    torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_param_names_and_shapes_round_trip():
    """JAX params -> port state_dict -> back through the JAX package's own
    torch importer gives the same tree; the port's modules hold exactly
    those keys and shapes."""
    _, params, flat = _jax_model_and_params(perturb=True)
    state = params_from_jax(flat)
    model = NCSNpp(**CFG)
    want = model.state_dict()
    assert set(state) == set(want)
    assert all(tuple(state[k].shape) == tuple(want[k].shape) for k in state)
    back = import_params(params, {k: v.numpy() for k, v in state.items()})
    back_flat = _flat(back)
    assert set(back_flat) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back_flat[k], flat[k])


def test_reference_torch_names():
    names = set(NCSNpp(**CFG).state_dict())
    for key in ("all_modules.0.W", "all_modules.1.weight",
                "all_modules.3.weight", "all_modules.4.Conv_0.weight",
                "all_modules.4.Dense_0.weight", "all_modules.4.GroupNorm_0.weight",
                "output_layer.weight"):
        assert key in names, key
    assert any(k.endswith("NIN_3.W") for k in names)


def test_attention_follows_static_resolution():
    """Attention blocks sit where image_size // 2**level is listed, at any
    input height (the static check of ditsep_tpu/models/ncsnpp.py)."""
    model = NCSNpp(**CFG)
    n_attn = sum(type(m).__name__ == "AttnBlockpp" for m in model.modules())
    # level 2 (32 // 4 == 8): one on the down path, one on the up path,
    # plus the middle block's
    assert n_attn == 3


def test_reset_parameters_is_seeded():
    a, b = NCSNpp(**CFG), NCSNpp(**CFG)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_bf16_compute_tracks_f32():
    """dtype=bfloat16 computes in bf16 with f32 parameters, as the JAX
    ``dtype`` field does; it stays near the f32 result."""
    _, _, flat = _jax_model_and_params(perturb=True)
    state = params_from_jax(flat)
    f32 = NCSNpp(**CFG).eval()
    bf16 = NCSNpp(**CFG, dtype=torch.bfloat16).eval()
    f32.load_state_dict(state)
    bf16.load_state_dict(state)
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 6, 32, 16)).astype(
        np.float32))
    t = torch.tensor([0.5])
    with torch.no_grad():
        want, got = f32(x, t), bf16(x, t)
    assert got.dtype == torch.bfloat16
    rel = (got.float() - want).norm() / want.norm()
    assert rel < 3e-2
