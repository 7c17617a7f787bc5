"""Parity of the port's fused bias-act (ditsep_tpu_torch.ops.fused_act and
the plain versions of the fba kernels) against the JAX package's composite
and its Pallas kernel with custom VJP (interpret mode on the CPU), in f32."""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.ops import fused_leaky_relu as jax_fused_leaky_relu
from ditsep_tpu.ops.pallas_kernels import fused_bias_act_pallas
from ditsep_tpu_torch.ops import cuda_kernels, fused_leaky_relu
from test_torch_separate import _imported_modules

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(2, 4, 8, 128), (4, 64, 64, 64), (7919, 64)]


def _inputs(shape, axis, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[axis]).astype(np.float32)
    return x, b


def _to_last(a, axis):
    return np.moveaxis(a, axis, -1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("with_bias", [True, False])
def test_forward_matches_jax(shape, axis, with_bias):
    x, b = _inputs(shape, axis)
    bt = torch.from_numpy(b) if with_bias else None
    got = fused_leaky_relu(torch.from_numpy(x), bt,
                           channel_axis=axis).numpy()
    jb = jnp.asarray(b) if with_bias else None
    want = np.asarray(jax_fused_leaky_relu(jnp.asarray(x), jb,
                                           channel_axis=axis))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the Pallas kernel takes the channel axis last: move it there
    pallas = np.asarray(fused_bias_act_pallas(
        jnp.asarray(_to_last(x, axis)),
        jnp.asarray(b if with_bias else np.zeros_like(b))))
    np.testing.assert_allclose(_to_last(got, axis), pallas, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [-1, 1])
def test_gradients_match_pallas_vjp(shape, axis):
    """torch.autograd of sum(out**2) against jax.grad through the Pallas
    custom VJP: dx to 1e-5 abs, dbias to 1e-4 relative (tests/test_pallas.py's
    bars), relative to max|dbias|: a channel whose sum cancels to near 0
    carries the rounding of the whole sum, summed in another order. The
    plain backward (the fba_bwd kernel's twin) gives the same dx."""
    x, b = _inputs(shape, axis, seed=1)
    xl = jnp.asarray(_to_last(x, axis))
    gx_j, gb_j = jax.grad(
        lambda x, b: jnp.sum(fused_bias_act_pallas(x, b) ** 2),
        argnums=(0, 1))(xl, jnp.asarray(b))
    gx_j = np.moveaxis(np.asarray(gx_j), -1, axis)
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = fused_leaky_relu(xt, bt, channel_axis=axis)
    gx, gb = torch.autograd.grad((out ** 2).sum(), (xt, bt))
    np.testing.assert_allclose(gx.numpy(), gx_j, atol=1e-5, rtol=0)
    gb_j = np.asarray(gb_j)
    np.testing.assert_allclose(gb.numpy(), gb_j,
                               atol=1e-4 * np.abs(gb_j).max(), rtol=0)
    dx = cuda_kernels.fused_bias_act_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(b), 2 * out.detach(),
        0.2, math.sqrt(2.0), axis)
    np.testing.assert_allclose(dx.numpy(), gx_j, atol=1e-5, rtol=0)


def test_custom_slope_and_scale_match_jax():
    x, b = _inputs((3, 5, 16), -1, seed=2)
    got = fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b),
                           negative_slope=0.1, scale=0.5).numpy()
    want = np.asarray(jax_fused_leaky_relu(jnp.asarray(x), jnp.asarray(b),
                                           negative_slope=0.1, scale=0.5))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_bf16_plain_rounds_once():
    """The plain version (the kernel's arithmetic) computes in f32 and
    rounds once to bf16."""
    x, b = _inputs((4, 32), -1, seed=3)
    xb = torch.from_numpy(x).bfloat16()
    bb = torch.from_numpy(b).bfloat16()
    got = fused_leaky_relu(xb, bb)
    s = xb.double() + bb.double()
    want = (torch.where(s >= 0, s, np.float32(0.2) * s)
            * np.float32(math.sqrt(2.0))).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("name", ["ops/fused_act.py", "ops/cuda_kernels.py",
                                  "ops/__init__.py"])
def test_ported_module_imports_no_jax(name):
    for mod in _imported_modules(REPO / "ditsep_tpu_torch" / name):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                         "ditsep_tpu"), f"{name}: {mod}"
