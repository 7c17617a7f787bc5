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
    CudaLibrary, conv3x3_bordered_plain,
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


@pytest.mark.parametrize("name", ["ops/conv3x3.py", "scripts/conv_probe.py",
                                  "scripts/conv_ablation.py",
                                  "scripts/__init__.py"])
def test_ported_module_imports_no_jax(name):
    for mod in _imported_modules(REPO / "ditsep_tpu_torch" / name):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                         "ditsep_tpu"), f"{name}: {mod}"
