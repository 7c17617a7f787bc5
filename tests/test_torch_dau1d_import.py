"""The port's DAU1d importer and diffusion autoencoder
(ditsep_tpu_torch/models/{torch_import,diffusion_ae}.py) against the JAX
package's: ``import_dau1d_params`` on a seeded state_dict in the
reference's layout, to the bit, and ``DiffusionAutoencoder.reconstruct``
with JAX's noise at 1e-3 of max|ref| (a pipeline: the sampler's steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import torch_import as jti
from ditsep_tpu_torch.models import dau1d as td
from ditsep_tpu_torch.models import torch_import as tti
from stable_audio_parity import init_shapes, load_jax, max_rel, redraw

PIPELINE_BAR = 1e-3
DAU = dict(io_channels=2, depth=4, n_attn_layers=2, channels=(8, 8, 16, 64),
           strides=(2, 2, 2))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("learned", [False, True])
def test_import_dau1d_params_matches_jax_importer(learned):
    """A seeded state_dict in the reference's layout through the port's
    importer equals, bit for bit, the JAX importer's tree carried over by
    ``params_from_jax``; ``dau1d_reference_state`` gives it back."""
    cfg = dict(DAU, learned_resample=learned)
    tm = td.DiffusionAttnUnet1D(**cfg)
    ref = {k: torch.from_numpy(_x(tuple(v.shape), i))
           for i, (k, v) in enumerate(
               tti.dau1d_reference_state(tm).items())}
    tti.import_dau1d_params(tm, ref)
    jtree = jti.import_dau1d_params({k: v.numpy() for k, v in ref.items()},
                                    depth=4, n_attn_layers=2)
    other = load_jax(td.DiffusionAttnUnet1D(**cfg), jtree)
    for k, v in other.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k
    back = tti.dau1d_reference_state(tm)
    assert set(back) == set(ref)
    assert all(torch.equal(back[k], ref[k]) for k in ref)
    if learned:
        assert "net.3.main.0.weight" in ref and "net.3.main.14.bias" in ref


def test_diffusion_autoencoder_reconstruct_matches_jax():
    """``reconstruct``: the oobleck encoder, then the v sampler over the
    adp U-Net with the latent concatenated, from JAX's noise."""
    from ditsep_tpu.models import factory as jf
    from ditsep_tpu_torch.models import factory as tf
    cfg = {"model_type": "diffusion_autoencoder", "model": {
        "latent_dim": 3, "downsampling_ratio": 4, "io_channels": 1,
        "encoder": {"type": "oobleck", "config": {
            "channels": 4, "c_mults": [1, 2], "strides": [2, 2],
            "latent_dim": 3}},
        "diffusion": {"type": "adp_1d", "config": {
            "in_channels": 4, "out_channels": 1, "channels": 8,
            "multipliers": [1, 2], "factors": [2], "num_blocks": [1],
            "attentions": [0, 1]}}}}
    jae, tae = jf.create_model_from_config(cfg), tf.create_model_from_config(
        cfg)
    audio = _x((2, 1, 32), 10)
    enc = redraw(init_shapes(jae.encoder, jnp.asarray(audio)), 11)
    diff = redraw(init_shapes(jae.diffusion, jnp.zeros((2, 4, 32)),
                              jnp.zeros((2,))), 12)
    load_jax(tae.encoder, enc)  # the OobleckEncoder's flax_names
    load_jax(tae.diffusion, diff)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jae.reconstruct(enc, diff, key, jnp.asarray(audio),
                                      steps=3))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (2, 1, 32))))
    with torch.no_grad():
        got = tae.reconstruct(torch.from_numpy(audio), steps=3, noise=noise)
    assert got.shape == (2, 1, 32)
    assert max_rel(got, want) <= PIPELINE_BAR
