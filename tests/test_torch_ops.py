"""The port's ops (ditsep_tpu_torch.ops) against the JAX package's on the CPU.

Inputs are made with numpy from a seed and fed to both sides; the port is
NCHW, the JAX ops NHWC, so results are transposed before comparing.
Tolerance: 1e-5 abs in f32, except the STFT (see test_stft_matches_jax).
The kernel's own tests need the card and live in test_torch_cuda.py, which
imports no JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.ops import fir as jfir
from ditsep_tpu.ops import stft as jstft
from ditsep_tpu.ops.pallas_kernels import downsample_2d_pallas
from ditsep_tpu.ops.stft import istft as jistft
from ditsep_tpu.ops.stft import n_frames_prepadded as j_n_frames
from ditsep_tpu.ops.upfirdn2d import setup_fir_kernel as j_setup
from ditsep_tpu.ops.upfirdn2d import upfirdn2d as jupfirdn2d
from ditsep_tpu_torch.ops import cuda_kernels, fir
from ditsep_tpu_torch.ops.stft import istft, n_frames_prepadded, stft
from ditsep_tpu_torch.ops.upfirdn2d import setup_fir_kernel, upfirdn2d

ATOL = 1e-5


def _nhwc(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _close(jax_nhwc, torch_nchw, atol=ATOL):
    got = torch_nchw.permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax_nhwc)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("k", [[1, 3, 3, 1], [1, 2, 3, 4],
                               [[1, 2], [3, 4]]])
def test_setup_fir_kernel_matches_jax(k):
    np.testing.assert_allclose(setup_fir_kernel(k, 2.5), j_setup(k, 2.5),
                               rtol=1e-7)


@pytest.mark.parametrize("up,down,pad", [
    (1, 2, (1, 1)),      # the downsample configuration
    (2, 1, (2, 1)),      # the upsample configuration (up-1 trailing zeros)
    (1, 1, (-1, 2)),     # negative pad crops
    (2, 2, (-2, -1)),    # both negative, with up and down
    (3, 1, (0, 0)),
])
def test_upfirdn2d_matches_jax(up, down, pad):
    rng = np.random.default_rng(0)
    x = _nhwc(rng, (2, 9, 12, 3))
    k = j_setup([1, 2, 3, 4])
    _close(jupfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad),
           upfirdn2d(_to_nchw(x), k, up=up, down=down, pad=pad))


@pytest.mark.parametrize("k", [[1, 3, 3, 1], [1, 2, 3, 4]])
@pytest.mark.parametrize("gain", [1.0, 2.5])
@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 9, 7, 2)])
def test_fir_resample_matches_jax(k, gain, shape):
    rng = np.random.default_rng(1)
    x = _nhwc(rng, shape)
    _close(jfir.upsample_2d(jnp.asarray(x), k, 2, gain),
           fir.upsample_2d(_to_nchw(x), k, 2, gain))
    _close(jfir.downsample_2d(jnp.asarray(x), k, 2, gain),
           cuda_kernels.downsample_2d_plain(_to_nchw(x), k, 2, gain))
    # on a CPU tensor the public op is the plain version
    _close(jfir.downsample_2d(jnp.asarray(x), k, 2, gain),
           fir.downsample_2d(_to_nchw(x), k, 2, gain))


@pytest.mark.parametrize("k", [[1, 3, 3, 1], [1, 2, 3, 4]])
@pytest.mark.parametrize("gain", [1.0, 0.5])
def test_downsample_plain_matches_pallas(k, gain):
    """Against the Pallas kernel the CUDA kernel replaces (interpret mode
    on the CPU), at even sizes, which is all the Pallas kernel takes."""
    rng = np.random.default_rng(2)
    x = _nhwc(rng, (2, 16, 32, 4))
    _close(downsample_2d_pallas(jnp.asarray(x), k, 2, gain),
           cuda_kernels.downsample_2d_plain(_to_nchw(x), k, 2, gain))


@pytest.mark.parametrize("k,gain", [([1, 3, 3, 1], 1.0), ([1, 2, 3, 4], 0.5)])
@pytest.mark.parametrize("shape", [
    (1, 8, 18, 256),  # the flagship's deepest plane, 8 x 18, at C = 256
    (2, 16, 36, 5),   # the one above it, 16 x 36
    (3, 17, 9, 2),    # odd: downsample_2d_pallas defers to the XLA
])                    # composite there
def test_downsample_plain_matches_pallas_deep_planes(shape, k, gain):
    """The plain version against downsample_2d_pallas (interpret mode on
    the CPU) at the main path's smallest planes, where the CUDA kernel
    takes its scalar path, and at an odd plane."""
    rng = np.random.default_rng(9)
    x = _nhwc(rng, shape)
    _close(downsample_2d_pallas(jnp.asarray(x), k, 2, gain),
           cuda_kernels.downsample_2d_plain(_to_nchw(x), k, 2, gain))


def test_downsample_plain_other_factors_and_2d_kernels():
    rng = np.random.default_rng(3)
    x = _nhwc(rng, (1, 12, 18, 2))
    for k, factor in (([1, 1, 1], 3), ([1, 2, 2, 1], 2),
                      ([[1, 2], [2, 1]], 2)):
        _close(jfir.downsample_2d(jnp.asarray(x), k, factor),
               fir.downsample_2d(_to_nchw(x), k, factor))


def test_downsample_plain_bf16_accumulates_in_f32():
    rng = np.random.default_rng(4)
    x = _to_nchw(_nhwc(rng, (1, 8, 10, 3))).to(torch.bfloat16)
    got = cuda_kernels.downsample_2d_plain(x, [1, 3, 3, 1])
    want = cuda_kernels.downsample_2d_plain(x.float(), [1, 3, 3, 1])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_naive_resample_matches_jax():
    rng = np.random.default_rng(5)
    x = _nhwc(rng, (2, 6, 8, 3))
    _close(jfir.naive_upsample_2d(jnp.asarray(x), 2),
           fir.naive_upsample_2d(_to_nchw(x), 2))
    _close(jfir.naive_downsample_2d(jnp.asarray(x), 2),
           fir.naive_downsample_2d(_to_nchw(x), 2))


def test_stft_matches_jax():
    """torch.stft against the JAX matmul DFT. The JAX op is itself off the
    float64 transform by ~3e-5 abs at unit-variance input, more than the
    1e-5 bar, so the port is held to 1e-5 abs against float64 and to 1e-5
    of max|ref| against JAX."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((2, 3, 1000)).astype(np.float32)
    got = stft(torch.from_numpy(w))
    want = np.asarray(jstft(jnp.asarray(w)))
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    exact = torch.stft(
        torch.from_numpy(w.astype(np.float64)).reshape(-1, 1000), 510, 128,
        510, torch.hann_window(510, dtype=torch.float64), center=True,
        pad_mode="constant", return_complex=True).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("length", [None, 700, 896, 1000, 1100])
def test_istft_length_rule(length):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((2, 3, 1000)).astype(np.float32)
    spec = np.array(jstft(jnp.asarray(w)))
    want = np.asarray(jistft(jnp.asarray(spec), length=length))
    got = istft(torch.from_numpy(spec), length=length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_istft_length_past_buffer_pads_zeros():
    """A length past the overlap-add buffer zero-pads its tail on both
    sides. (The last samples before the pad divide by a window envelope
    near 1e-9, which amplifies rounding, so they are not compared.)"""
    rng = np.random.default_rng(8)
    w = rng.standard_normal((1, 1, 1000)).astype(np.float32)
    spec = np.array(jstft(jnp.asarray(w)))
    n_frames = spec.shape[-1]
    retained = (n_frames - 1) * 128 + 510 - 255  # buffer end - start
    length = retained + 200
    want = np.asarray(jistft(jnp.asarray(spec), length=length))
    got = istft(torch.from_numpy(spec), length=length).numpy()
    assert got.shape == want.shape == (1, 1, length)
    assert not got[..., retained:].any() and not want[..., retained:].any()
    np.testing.assert_allclose(got[..., :1000], want[..., :1000], rtol=0,
                               atol=ATOL)


def test_istft_envelope_never_under_guard():
    """torch.istft raises where the squared-window envelope of the retained
    region is under 1e-11, where the JAX op divides by 1. For the score
    model's periodic Hann 510/128, center on, and its n_fft - hop pre-pad,
    no retained sample falls there at any length: torch.istft is safe."""
    n_fft, hop = 510, 128
    win2 = (0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))) ** 2
    for length in range(n_fft, 4 * 8000, 37):
        padded = length + n_fft - hop
        n_frames = padded // hop + 1  # center=True
        env = np.zeros((n_frames - 1) * hop + n_fft)
        for i in range(n_frames):
            env[i * hop:i * hop + n_fft] += win2
        start = n_fft // 2
        assert env[start:start + length].min() > 1e-11, length


def test_n_frames_prepadded_matches_jax():
    for length in (1, 127, 128, 8000, 67320):
        assert n_frames_prepadded(length, 510, 128) == j_n_frames(
            length, 510, 128)
    lengths = torch.tensor([1000, 67320])
    assert n_frames_prepadded(lengths, 510, 128).tolist() == [
        j_n_frames(1000, 510, 128), j_n_frames(67320, 510, 128)]


@pytest.mark.parametrize("k,factor", [([1, 1, 1], 3), ([1, 2, 2, 1, 1], 2),
                                      ([[1, 2], [2, 1]], 2), ([1, 1], 2)])
def test_cuda_path_rejects_unsupported_kernel(k, factor):
    """The CUDA path raises on configurations fir_down2d does not take; it
    never falls back to the plain version."""
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="fir_down2d"):
        cuda_kernels.downsample_2d_cuda(x, k, factor=factor)


def test_kernel_wrapper_rejects_cpu_tensor():
    before = cuda_kernels.fir_down2d.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.fir_down2d(torch.zeros(1, 2, 8, 8), [0.25] * 4,
                                [0.25] * 4)
    assert cuda_kernels.fir_down2d.launches == before
