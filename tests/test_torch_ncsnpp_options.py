"""NCSN++'s other block options in the port (DDPM residual blocks, the conv
variants of Upsample / Downsample, ResampleConv2d, ``progressive`` /
``progressive_input`` = 'residual') against the JAX package's NCSNpp on the
CPU, nf=16, 3 levels of widths 16, 32, 16 (so that a residual pyramid
changes width between levels), the same redrawn weights through
``params_from_jax``: the forward within 1e-4 max|ref| (model forwards),
with and without a frame mask; ``upsample_conv_2d`` / ``conv_downsample_2d``
alone within 1e-5 abs (ops); the FIR downsamples a forward calls (the
``fir_down2d`` launches on the card), counted on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_parity import flat, init_shapes, redraw

from ditsep_tpu.models import NCSNpp as JaxNCSNpp
from ditsep_tpu.ops import fir as jax_fir
from ditsep_tpu_torch.models import NCSNpp
from ditsep_tpu_torch.models.weights import load_state, params_from_jax
from ditsep_tpu_torch.ops import fir

OPS_TOL = 1e-5      # abs, ops
MODEL_TOL = 1e-4    # of max|ref|, model forwards
BASE = dict(nf=16, ch_mult=(1, 2, 1), num_res_blocks=1,
            attn_resolutions=(8,), image_size=16, num_channels_in=6,
            num_channels_out=4)
OPTIONS = {
    # the chip's first option config: DDPM blocks, FIR Downsample between
    # levels (fir_down2d) and the input_skip pyramid's
    "ddpm_fir": dict(resblock_type="ddpm", resamp_with_conv=False),
    "ddpm_fir_conv": dict(resblock_type="ddpm", resamp_with_conv=True,
                          progressive="none", progressive_input="none"),
    "ddpm_conv": dict(resblock_type="ddpm", resamp_with_conv=True, fir=False,
                      skip_rescale=False),
    "ddpm_pool": dict(resblock_type="ddpm", resamp_with_conv=False,
                      fir=False),
    # the chip's second: BigGAN blocks, both pyramids residual
    "biggan_residual": dict(progressive="residual",
                            progressive_input="residual"),
    "biggan_residual_noskip": dict(progressive="residual",
                                   progressive_input="residual",
                                   skip_rescale=False),
    "ddpm_residual": dict(resblock_type="ddpm", progressive="residual",
                          progressive_input="residual"),
    "residual_out_cat_in": dict(progressive="residual",
                                progressive_input="input_skip",
                                progressive_combine="cat"),
}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(name, seed):
    cfg = {**BASE, **OPTIONS[name]}
    jm = JaxNCSNpp(**cfg)
    x = jnp.zeros((1, 16, 8, 6))
    tree = redraw(init_shapes(jm, x, jnp.full((1,), 0.5)), seed, scale=0.6)
    port = NCSNpp(**cfg).eval()
    load_state(port, params_from_jax(flat(tree), port))
    return jm, tree, port


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_forward_matches_jax(name):
    jm, tree, port = _pair(name, seed=len(name))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 8, 6)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(jax.jit(jm.apply)(tree, x, t))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= MODEL_TOL, f"{name}: {err:.3g}"


@pytest.mark.parametrize("name", ["ddpm_fir", "biggan_residual"])
def test_option_forward_masked_matches_jax(name):
    """A frame mask: every GroupNorm's statistics over the valid columns
    (the DDPM blocks take it too), attention keys masked."""
    jm, tree, port = _pair(name, seed=7)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 8, 6)).astype(np.float32)
    t = np.array([0.5, 0.2], np.float32)
    mask = np.arange(8)[None, :] < np.array([[8], [5]])
    want = np.asarray(jax.jit(lambda p, a, b, m: jm.apply(
        p, a, b, time_mask=m))(tree, x, t, mask))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), time_mask=torch.from_numpy(mask)
                   ).permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= MODEL_TOL, f"{name}: {err:.3g}"


@pytest.mark.parametrize("k,gain", [((1, 3, 3, 1), 1.0), ((1, 2, 1), 2.0)])
@pytest.mark.parametrize("kh", [3, 1])
def test_conv_resamplers_match_jax(k, gain, kh):
    """x (N, H, W, C) and w HWIO in JAX, NCHW and OIHW in the port."""
    rng = np.random.default_rng(kh)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    w = rng.standard_normal((kh, kh, 3, 5)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    for port_fn, jax_fn, size in (
            (fir.upsample_conv_2d, jax_fir.upsample_conv_2d, (16, 12)),
            (fir.conv_downsample_2d, jax_fir.conv_downsample_2d, (4, 3))):
        got = port_fn(xt, wt, k=k, gain=gain).permute(0, 2, 3, 1).numpy()
        want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(w), k=k,
                                 gain=gain))
        assert got.shape == want.shape == (2, *size, 5)
        np.testing.assert_allclose(got, want, rtol=0, atol=OPS_TOL)


@pytest.mark.parametrize("name,levels,per_level", [
    ("ddpm_fir", 6, 2), ("ddpm_fir_conv", 6, 0), ("ddpm_pool", 6, 0),
    ("biggan_residual", 6, 2), ("residual_out_cat_in", 2, 3)])
def test_fir_down2d_launch_count_is_what_the_forward_runs(monkeypatch, name,
                                                          levels, per_level):
    """The FIR downsamples without a conv (``ops.fir.downsample_2d``, the
    kernel's wrapper on the card) that a forward calls: 2 a level
    transition with BigGAN blocks, 1 with a DDPM FIR ``Downsample``, 1 more
    with the input_skip pyramid; at 7 levels (the flagship's depth) the
    two chip option configs make 12 a forward (the flagship's BigGAN +
    input_skip 18)."""
    calls = []
    real = fir.downsample_2d
    monkeypatch.setattr(fir, "downsample_2d",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def fir_downsamples(opts, levels):
        size = 2 ** (levels + 1)
        model = NCSNpp(**{**BASE, **opts, "ch_mult": (1,) * (levels + 1),
                          "nf": 4, "attn_resolutions": (),
                          "image_size": size}).eval()
        calls.clear()
        with torch.no_grad():
            model(torch.zeros(1, 6, size, size), torch.full((1,), 0.5))
        return len(calls)

    assert fir_downsamples(OPTIONS[name], levels) == levels * per_level
    assert fir_downsamples({}, 6) == 18


def test_only_the_fourier_embedding_is_refused():
    with pytest.raises(NotImplementedError, match="fourier"):
        NCSNpp(**BASE, embedding_type="positional")
    with pytest.raises(AssertionError):  # JAX asserts the same
        JaxNCSNpp(**BASE, embedding_type="positional").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16, 8, 6)),
            jnp.full((1,), 0.5))
    with pytest.raises(ValueError, match="unrecognized"):
        NCSNpp(**BASE, resblock_type="plain")
