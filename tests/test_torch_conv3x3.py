"""Parity of the port's bordered 3x3 conv (the plain version of the conv
probe's kernels, ditsep_tpu_torch.ops.conv3x3 on the CPU) against the
probe's oracle, ``lax.conv_general_dilated(..., "VALID")`` on the bordered
input (scripts/pallas_conv_probe.py:238-240), and the probe script's CPU
parity mode. The probe script itself is not imported: it sets a JAX cache
directory at import and fixes the 576x256 shape."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu_torch.ops import conv3x3_bordered, conv3x3_bordered_async
from ditsep_tpu_torch.ops.cuda_kernels import (
    CONV_SMEM_LIMIT, CudaLibrary, conv3x3_bordered_plain, conv3x3_plan,
    conv3x3_smem_bytes,
)
from ditsep_tpu_torch.scripts import conv_probe
from ditsep_tpu_torch.utils.device import card_peaks
from test_torch_separate import _imported_modules

REPO = Path(__file__).resolve().parents[1]


def _case(b, h, w, c, c2, padw, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.1 * rng.standard_normal((b, h, w, c)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (padw, padw), (0, 0)))
    w9 = 0.05 * rng.standard_normal((9, c, c2)).astype(np.float32)
    return xp, w9


def _oracle(xp, w9, padw, dtype):
    """The probe's check: VALID conv in f32 on the 1-pixel-bordered input."""
    x1 = xp[:, :, padw - 1:xp.shape[2] - (padw - 1)]
    c, c2 = w9.shape[1:]
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x1, dtype).astype(jnp.float32),
        jnp.asarray(w9, dtype).astype(jnp.float32).reshape(3, 3, c, c2),
        (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC")))


def _borders(y, padw):
    return np.concatenate([y[:, :1].ravel(), y[:, -1:].ravel(),
                           y[:, :, :padw].ravel(), y[:, :, -padw:].ravel()])


@pytest.mark.parametrize("padw", [1, 4])
@pytest.mark.parametrize("c,c2", [(16, 16), (32, 32), (16, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_lax_conv(padw, c, c2, dtype):
    b, h, w = 2, 18, 34
    xp, w9 = _case(b, h, w, c, c2, padw)
    tdt = getattr(torch, dtype)
    y = conv3x3_bordered_plain(torch.from_numpy(xp).to(tdt),
                               torch.from_numpy(w9).to(tdt), padw)
    assert y.shape == (b, h + 2, w + 2 * padw, c2) and y.dtype == tdt
    y = y.float().numpy()
    ref = _oracle(xp, w9, padw, getattr(jnp, dtype))
    tol = (1e-5 if dtype == "float32" else 2.0 ** -7) * np.abs(ref).max()
    np.testing.assert_allclose(y[:, 1:-1, padw:padw + w], ref, atol=tol,
                               rtol=0)
    assert (_borders(y, padw) == 0).all()


def test_public_functions_take_plain_on_cpu():
    xp, w9 = _case(1, 9, 17, 16, 32, 1, seed=1)
    x, w = torch.from_numpy(xp).bfloat16(), torch.from_numpy(w9).bfloat16()
    assert torch.equal(conv3x3_bordered(x, w),
                       conv3x3_bordered_plain(x, w, 1))
    xp4, _ = _case(1, 9, 17, 16, 32, 4, seed=1)
    x4 = torch.from_numpy(xp4).bfloat16()
    assert torch.equal(conv3x3_bordered_async(x4, w),
                       conv3x3_bordered_plain(x4, w, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv3x3_bordered(x.to("meta"), w.to("meta"))


def test_borders_of_input_are_read_as_given():
    """Like the TPU kernels, the conv reads the input's borders as they
    are (the layout's contract makes them zero); only the output's are
    forced to zero."""
    xp, w9 = _case(1, 6, 10, 16, 16, 1, seed=2)
    xp[:, 0] = 1.0
    y = conv3x3_bordered_plain(torch.from_numpy(xp),
                               torch.from_numpy(w9), 1).numpy()
    ref = _oracle(xp, w9, 1, jnp.float32)
    np.testing.assert_allclose(y[:, 1:-1, 1:-1], ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=0)
    assert (_borders(y, 1) == 0).all()


def test_probe_cpu_parity_mode():
    out = conv_probe.parity(b=2, h=13, w=37, c=16, c2=32, device="cpu")
    assert out["border_max"] == 0.0
    assert out["plain_f32_vs_conv2d"] <= out["f32_tolerance"]
    assert out["max_abs_err_9tap"] == out["max_abs_err_async_halo"] == 0.0


def test_probe_bound_and_peak_tables():
    flops = conv_probe.conv_flops(16, 576, 256, 128, 128)
    assert flops == pytest.approx(6.96e11, rel=1e-3)
    peak, bw = card_peaks("NVIDIA H100 80GB HBM3")
    assert (peak, bw) == (989e12, 3.35e12)
    assert flops / peak * 1e3 == pytest.approx(0.704, rel=1e-3)
    assert card_peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)


# output channels a CTA keeps resident, by C, at C2 = 128: 64 while the
# 9 x kp x 64 weights (kp: C padded to a multiple of 64) fit beside the
# halo and staging, then 32, then 16
_PLAN_NS = {16: 64, 32: 64, 128: 64, 144: 32, 160: 32, 288: 16}


@pytest.mark.parametrize("is_async", [False, True], ids=["9tap", "async"])
@pytest.mark.parametrize("c", sorted(_PLAN_NS))
def test_conv3x3_plan_fits_shared_memory(c, is_async):
    plan = conv3x3_plan(c, 128, 4 if is_async else 1, is_async)
    assert plan["ns"] == _PLAN_NS[c]
    assert plan["smem_bytes"] <= CONV_SMEM_LIMIT
    assert plan["n_slices"] == 128 // plan["ns"]
    assert plan["tile"] == (8, 16)
    assert plan["threads"] == (384 if is_async else 256)
    # one CTA an SM, rounded down so that each keeps one slice
    assert plan["ctas"] == 132 // plan["n_slices"] * plan["n_slices"]
    assert plan["smem_bytes"] == conv3x3_smem_bytes(c, plan["ns"], is_async)
    if plan["ns"] < 64:  # the next wider slice would not fit
        assert conv3x3_smem_bytes(c, 2 * plan["ns"],
                                  is_async) > CONV_SMEM_LIMIT


@pytest.mark.parametrize("is_async,c_max", [(False, 320), (True, 576)],
                         ids=["9tap", "async"])
def test_conv3x3_plan_refuses_past_the_limit(is_async, c_max):
    padw = 4 if is_async else 1
    assert conv3x3_plan(c_max, 128, padw, is_async)["ns"] == 16
    with pytest.raises(ValueError, match="shared memory"):
        conv3x3_plan(c_max + 16, 128, padw, is_async)
    with pytest.raises(ValueError, match="multiples of 16"):
        conv3x3_plan(24, 128, padw, is_async)
    if not is_async:
        with pytest.raises(ValueError, match="padw"):
            conv3x3_plan(128, 128, 4, is_async)


def test_conv3x3_plan_at_the_probe_shape_and_odd_widths():
    """The probe's conv: NS = 64, two slices, 132 CTAs, the shared memory
    the kernels' design states (212.0 KB async, 218.1 KB 9-tap); narrow or
    ragged C2; a grid capped at one CTA an item."""
    nine, dma = conv3x3_plan(128, 128, 1, False), conv3x3_plan(128, 128, 4, True)
    assert (nine["ns"], nine["n_slices"], nine["ctas"]) == (64, 2, 132)
    assert (dma["ns"], dma["n_slices"], dma["ctas"]) == (64, 2, 132)
    assert (nine["smem_bytes"], dma["smem_bytes"]) == (218112, 212000)
    assert conv3x3_plan(32, 16, 1, False)["ns"] == 16
    assert conv3x3_plan(32, 32, 4, True)["ns"] == 32
    assert conv3x3_plan(32, 48, 1, False)["n_slices"] == 1
    ragged = conv3x3_plan(16, 160, 4, True)
    assert (ragged["ns"], ragged["n_slices"], ragged["ctas"]) == (64, 3, 132)
    assert conv3x3_plan(128, 128, 1, False, sms=132, n_tiles=5)["ctas"] == 10
    assert conv3x3_plan(128, 128, 1, False, sms=7)["ctas"] == 6


def test_ablation_edits_apply_to_the_source(tmp_path):
    """A variant build (the ablation's) compiles the edited source under
    its own hash, and an edit whose text is not in the source raises
    before anything is compiled, so a stale edit cannot time the
    unchanged kernel under another name."""
    cu = tmp_path / "k.cu"
    cu.write_text("int f() { return 1; }\n")
    base = CudaLibrary(str(cu))
    variant = CudaLibrary(str(cu), [("return 1", "return 2")])
    src, out = variant.target()
    assert src == "int f() { return 2; }\n"
    assert out != base.target()[1] and out.name.startswith("libk-")
    assert base.target()[0] == cu.read_text()
    with pytest.raises(RuntimeError, match="not in the source"):
        CudaLibrary(str(cu), [("return 3", "")]).build()


def test_ablation_variants_edit_the_conv_source():
    """Every variant of scripts/conv_ablation.py finds its texts in
    csrc/conv3x3.cu, so none times the unchanged kernel."""
    from ditsep_tpu_torch.scripts.conv_ablation import EDITS
    base = CudaLibrary("conv3x3.cu").target()
    for name, edits in EDITS.items():
        src, out = CudaLibrary("conv3x3.cu", edits).target()
        assert (src == base[0]) == (name == "base"), name
        assert (out == base[1]) == (name == "base"), name


@pytest.mark.parametrize("name", ["ops/conv3x3.py", "scripts/conv_probe.py",
                                  "scripts/conv_ablation.py",
                                  "scripts/__init__.py"])
def test_ported_module_imports_no_jax(name):
    for mod in _imported_modules(REPO / "ditsep_tpu_torch" / name):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                         "ditsep_tpu"), f"{name}: {mod}"
