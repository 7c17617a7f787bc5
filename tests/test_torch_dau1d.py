"""The port's dance-diffusion U-Net (ditsep_tpu_torch/models/dau1d.py)
against the JAX package's, on seeded inputs with the JAX parameters
redrawn from a seed and carried over by ``params_from_jax``; its importer
and the diffusion autoencoder are in tests/test_torch_dau1d_import.py.

Bars: the resamplers and the linear resize (ops) 1e-5 abs; the U-Net 1e-4
of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import dau1d as jd
from ditsep_tpu_torch.models import dau1d as td
from ditsep_tpu_torch.models.weights import params_to_jax
from stable_audio_parity import (flat, init_shapes, load_jax, max_rel,
                                 redraw)

OP_BAR = 1e-5
MODEL_BAR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nwc(x):
    return jnp.asarray(np.swapaxes(x, 1, 2))


@pytest.mark.parametrize("kernel", ["linear", "cubic", "lanczos3"])
def test_fir_resamplers_match_jax(kernel):
    x = _x((2, 3, 20), 1)
    for jf, tf in ((jd._fir_downsample, td._fir_downsample),
                   (jd._fir_upsample, td._fir_upsample)):
        want = np.swapaxes(np.asarray(jf(_nwc(x), kernel)), 1, 2)
        got = tf(torch.from_numpy(x), kernel).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= OP_BAR


@pytest.mark.parametrize("length", [7, 20, 33, 80])
def test_linear_resize_is_jax_image_resize(length):
    """Both directions: upsampling interpolates, downsampling widens the
    triangle kernel (JAX's antialiasing; ``F.interpolate`` would not)."""
    x = _x((2, 3, 20), 2)
    want = np.asarray(jax.image.resize(_nwc(x), (2, length, 3), "linear"))
    got = td.linear_resize(torch.from_numpy(x), length).numpy()
    assert np.abs(got - np.swapaxes(want, 1, 2)).max() <= OP_BAR


DAU = dict(io_channels=2, depth=3, channels=(8, 16, 64), strides=(2, 2))
DAU_CASES = {  # attention at every level (two heads at 64), or at none
    "fir": {"n_attn_layers": 1},
    "learned_resample": {"learned_resample": True, "kernel_size": 3,
                         "conv_bias": False, "n_attn_layers": 0},
    "cond_longer_aug": {"cond_dim": 3, "cond_len": 50,
                        "cond_noise_aug": True, "n_attn_layers": 1},
    "cond_shorter_aug_scale": {"cond_dim": 3, "cond_len": 13,
                               "cond_noise_aug": True,
                               "cond_aug_scale": 0.3, "n_attn_layers": 0},
}


@pytest.mark.parametrize("case", sorted(DAU_CASES))
def test_dau1d_matches_jax(case):
    """The U-Net with FIR or learned resampling, a cond shorter and longer
    than T, and the cond noise augmentation on JAX's draws (its key split
    into the level's uniform and the noise's normal, or the key alone with
    a fixed ``cond_aug_scale``)."""
    c = dict(DAU_CASES[case])
    cond_len = c.pop("cond_len", None)
    scale = c.pop("cond_aug_scale", None)
    jm, tm = jd.DiffusionAttnUnet1D(**DAU, **c), td.DiffusionAttnUnet1D(
        **DAU, **c)
    x, t = _x((2, 2, 32), 3), np.asarray([0.2, 0.7], np.float32)
    kw, tkw = {}, {}
    key = jax.random.PRNGKey(4)
    if cond_len:
        cond = _x((2, 3, cond_len), 5)
        kw["cond"], tkw["cond"] = jnp.asarray(cond), torch.from_numpy(cond)
    if c.get("cond_noise_aug"):
        kw["key"] = key
        if scale is None:
            k_lvl, k_noise = jax.random.split(key)
            tkw["aug_level"] = torch.from_numpy(np.array(
                jax.random.uniform(k_lvl, (2,))))
        else:
            k_noise = key
            kw["cond_aug_scale"] = tkw["cond_aug_scale"] = scale
        tkw["cond_noise"] = torch.from_numpy(np.swapaxes(np.array(
            jax.random.normal(k_noise, (2, 32, 3))), 1, 2).copy())
    params = redraw(init_shapes(jm, jnp.asarray(x), jnp.asarray(t), **kw), 6)
    load_jax(tm, params)
    kw.pop("cond_aug_scale", None)
    want = np.asarray(jax.jit(lambda p, a, b, k: jm.apply(
        p, a, b, cond_aug_scale=scale, **k))(
        params, jnp.asarray(x), jnp.asarray(t), kw))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), **tkw)
    assert got.shape == (2, 2, 32)
    assert max_rel(got, want) <= MODEL_BAR


def test_res_conv_block_snake_and_its_refusal():
    """Snake activations where the two widths differ (and on a last
    block) against JAX; where they are equal both packages refuse (flax's
    ``snake_a_{width}`` names collide)."""
    for cm, co, last in ((6, 4, False), (6, 3, True)):
        jm = jd.ResConvBlock(cm, co, is_last=last, use_snake=True)
        tm = td.ResConvBlock(5, cm, co, is_last=last, use_snake=True)
        x = _x((2, 5, 12), 7)
        params = redraw(init_shapes(jm, _nwc(x)), 8)
        load_jax(tm, params)
        want = np.swapaxes(np.asarray(jm.apply(params, _nwc(x))), 1, 2)
        with torch.no_grad():
            assert max_rel(tm(torch.from_numpy(x)), want) <= MODEL_BAR
    with pytest.raises(Exception):
        init_shapes(jd.DiffusionAttnUnet1D(**DAU, n_attn_layers=1,
                                           use_snake=True),
                    jnp.zeros((1, 2, 32)), jnp.zeros((1,)))
    with pytest.raises(ValueError, match="use_snake"):
        td.DiffusionAttnUnet1D(**DAU, n_attn_layers=1, use_snake=True)


def test_scale_params_matches_jax():
    jm = jd.DiffusionAttnUnet1D(**DAU, n_attn_layers=1)
    tm = td.DiffusionAttnUnet1D(**DAU, n_attn_layers=1)
    params = redraw(init_shapes(jm, jnp.zeros((1, 2, 32)), jnp.zeros((1,))),
                    9)
    load_jax(tm, params)
    want = flat(jd.scale_params(params, 0.5))
    got = params_to_jax(td.scale_params(tm, 0.5))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k[len("params/"):]], v)
