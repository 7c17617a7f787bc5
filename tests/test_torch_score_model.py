"""The port's ScoreModelNCSNpp against the JAX one, on the repository's
trained checkpoint examples/checkpoints/masked_synthetic_ema.npz (nf=32,
ch_mult (1,1,2,2), attention at 32), loaded on both sides with
mask_padding off. Tolerance 1e-4 * max|ref|.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models.score_models import ScoreModelNCSNpp as JaxScoreModel
from ditsep_tpu.utils.checkpoint import load_params_npz as jax_load_npz
from ditsep_tpu_torch.models import NCSNpp, ScoreModelNCSNpp, load_params_npz

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "checkpoints", "masked_synthetic_ema.npz")
CFG = dict(nf=32, ch_mult=(1, 1, 2, 2), attn_resolutions=(32,))
TOL = 1e-4


def load_jax_side():
    """The jitted JAX apply and the checkpoint's parameters."""
    model = JaxScoreModel(**CFG)
    tmpl = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 2, 1000)), jnp.full((1,), 0.5),
                          jnp.zeros((1, 1, 1000)))
    tmpl = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tmpl["params"])
    return jax.jit(model.apply), jax_load_npz(CKPT, tmpl)


@pytest.fixture(scope="module")
def jax_side():
    return load_jax_side()


@pytest.fixture(scope="module")
def port_model():
    return load_params_npz(CKPT, ScoreModelNCSNpp(**CFG)).eval()


# 2000 samples -> 19 frames (45 of frame pad); 7700 -> 64 frames (no pad)
@pytest.mark.parametrize("length,t", [(2000, 0.5), (7700, 0.9)])
def test_score_model_checkpoint_matches_jax(jax_side, port_model, length, t):
    apply, params = jax_side
    rng = np.random.default_rng(length)
    xt = rng.standard_normal((2, 2, length)).astype(np.float32)
    mix = rng.standard_normal((2, 1, length)).astype(np.float32)
    tc = np.array([t, 0.1], np.float32)
    want = np.asarray(apply({"params": params}, jnp.asarray(xt),
                               jnp.asarray(tc), jnp.asarray(mix)))
    with torch.no_grad():
        got = port_model(torch.from_numpy(xt), torch.from_numpy(tc),
                         torch.from_numpy(mix)).numpy()
    assert got.shape == want.shape == (2, 2, length)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_pre_process_pads_frames_to_64(port_model):
    h, n_samples, n_pad = port_model.pre_process(torch.zeros(1, 3, 2000))
    assert n_samples == 2000 and n_pad == 64 - 19
    assert h.shape == (1, 6, 256, 64) and h.is_contiguous()


def test_load_params_npz_fits_bare_backbone(port_model):
    """The npz's backbone/ prefix is stripped for a bare NCSNpp."""
    bare = load_params_npz(CKPT, NCSNpp(
        nf=32, ch_mult=(1, 1, 2, 2), attn_resolutions=(32,), image_size=256,
        num_channels_in=6, num_channels_out=4, num_res_blocks=2))
    want = port_model.backbone.state_dict()
    for k, v in bare.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_load_params_npz_rejects_wrong_config():
    with pytest.raises((KeyError, ValueError)):
        load_params_npz(CKPT, ScoreModelNCSNpp(nf=16, ch_mult=(1, 1, 2, 2),
                                               attn_resolutions=(32,)))


def test_load_params_npz_accepts_params_wrapper(tmp_path, port_model):
    """The same weights under the flax collection wrapper ('params/...')."""
    wrapped = tmp_path / "wrapped.npz"
    with np.load(CKPT) as data:
        np.savez(wrapped, **{f"params/{k}": data[k] for k in data.files})
    model = load_params_npz(str(wrapped), ScoreModelNCSNpp(**CFG))
    want = port_model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
