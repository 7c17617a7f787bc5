"""``generate_diffusion_cond`` and ``GenerationApp`` (ditsep_tpu_torch/
inference/generation.py, interface/app.py) through the model factory
against the JAX package's, on a tiny Stable Audio Open-shaped config (an
Oobleck VAE pretransform, a T5-style prompt embedding with its mask and
the two seconds conditioners, a DiT with cross-attention and a prepended
global token, one layer deep) built by both factories, the JAX
weights redrawn from a seed and carried over, on JAX's initial noise: the
v sampler, k-heun, the rectified-flow Euler sampler, a variation with an
inpaint mask, and JAX's own app. Bar: 1e-3 of max|ref|.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.inference import generation as jg
from ditsep_tpu.interface.app import GenerationApp as JApp
from ditsep_tpu.models import conditioners as jc
from ditsep_tpu.models import factory as jf
from ditsep_tpu_torch.interface import GenerationApp
from ditsep_tpu_torch.models import conditioners as tcond
from ditsep_tpu_torch.models import factory as tf
from stable_audio_parity import init_shapes, load_jax, max_rel, redraw

GEN_BAR = 1e-3
KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


SAO_TINY = {
    "model_type": "diffusion_cond", "sample_size": 256, "sample_rate": 8000,
    "model": {
        "pretransform": {"type": "autoencoder", "config": {
            "encoder": {"type": "oobleck", "config": {
                "in_channels": 2, "channels": 4, "c_mults": [1, 2],
                "strides": [2, 2], "latent_dim": 6, "use_snake": True}},
            "decoder": {"type": "oobleck", "config": {
                "out_channels": 2, "channels": 4, "c_mults": [1, 2],
                "strides": [2, 2], "latent_dim": 3, "use_snake": True}},
            "bottleneck": {"type": "vae"}, "latent_dim": 3,
            "downsampling_ratio": 4, "io_channels": 2}},
        "conditioning": {"cond_dim": 12, "configs": [
            {"id": "prompt", "type": "t5",
             "config": {"max_length": 6, "input_dim": 10}},
            {"id": "seconds_start", "type": "number",
             "config": {"min_val": 0, "max_val": 512}},
            {"id": "seconds_total", "type": "number",
             "config": {"min_val": 0, "max_val": 512}}]},
        "diffusion": {
            "cross_attention_cond_ids": ["prompt", "seconds_start",
                                         "seconds_total"],
            "global_cond_ids": ["seconds_start", "seconds_total"],
            "type": "dit", "config": {
                "io_channels": 3, "embed_dim": 32, "depth": 1,
                "num_heads": 4, "cond_token_dim": 12, "global_cond_dim": 24,
                "project_cond_tokens": False}},
        "io_channels": 3}}


def _cond_inputs(batch=1):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((batch, 6, 10)).astype(np.float32)
    mask = np.ones((batch, 6), bool)
    mask[:, 4:] = False
    return {"prompt": (emb, mask),
            "seconds_start": np.zeros(batch, np.float32),
            "seconds_total": np.full(batch, 47.0, np.float32)}


def _built(objective="v"):
    """Both factories' models on the same weights, the DiT's objective
    set to ``objective``."""
    (cfg, jdit, dparams, jrouting, jcond, cvars, jpre, tdit, trouting,
     tcond_m, tpre) = _built_v()
    if objective != "v":
        jdit = jdit.clone(diffusion_objective=objective)
        tdit = copy.deepcopy(tdit)
        tdit.diffusion_objective = objective
    return (cfg, jdit, dparams, jrouting, jcond, cvars, jpre, tdit,
            trouting, tcond_m, tpre)


@functools.lru_cache(maxsize=None)
def _built_v():
    """Both factories' models on the same weights: the DiT and the
    conditioners redrawn, the VAE JAX's own initialisation (built once:
    the JAX factory compiles the VAE's initialisation)."""
    cfg = SAO_TINY
    jdit, jrouting, jcfgs, jpre = jf.create_diffusion_cond_from_config(
        cfg, include_pretransform=True)
    tdit, trouting, _, tpre = tf.create_diffusion_cond_from_config(
        cfg, include_pretransform=True)
    jcond = jc.create_multi_conditioner_from_config(
        cfg["model"]["conditioning"])
    tcond_m = tcond.create_multi_conditioner_from_config(
        cfg["model"]["conditioning"])
    inputs = _cond_inputs()
    jin = {k: ((jnp.asarray(v[0]), jnp.asarray(v[1]))
               if isinstance(v, tuple) else jnp.asarray(v))
           for k, v in inputs.items()}
    cvars = redraw(jax.eval_shape(lambda: jcond.init(KEY, jin)), 4)
    load_jax(tcond_m, cvars)
    jcond_out = jcond(cvars, jin)
    jkw = jrouting.gather(jcond_out)
    x = jnp.zeros((1, 3, 64))
    dparams = redraw(init_shapes(jdit, x, jnp.zeros(1), **jkw), 5)
    load_jax(tdit, dparams)
    load_jax(tpre.model, jax.tree_util.tree_map(np.asarray, jpre.params))
    return (cfg, jdit, dparams, jrouting, jcond, cvars, jpre,
            tdit, trouting, tcond_m, tpre)


GEN_CASES = {
    "v": dict(),
    "k_heun": dict(sampler_type="k-heun"),
    "rf_euler": dict(objective="rectified_flow"),
    "variation_inpaint": dict(init=True),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generation_app_matches_jax(case):
    """``GenerationApp.generate_conditional`` with the factory's
    pretransform against JAX's ``generate_diffusion_cond`` with the same
    pretransform, conditioning and JAX's initial noise (4 steps, CFG 3)."""
    c = GEN_CASES[case]
    objective = c.get("objective", "v")
    (cfg, jdit, dparams, jrouting, jcond, cvars, jpre, tdit, trouting,
     tcond_m, tpre) = _built(objective)
    inputs = _cond_inputs()
    jin = {k: ((jnp.asarray(v[0]), jnp.asarray(v[1]))
               if isinstance(v, tuple) else jnp.asarray(v))
           for k, v in inputs.items()}
    init = mask = None
    kw = {}
    if c.get("init"):
        t = np.arange(200, dtype=np.float32) / 8000.0
        init = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        mask = np.zeros(64, np.float32)
        mask[20:44] = 1.0
        mono = np.broadcast_to(init[None, None, :] / np.abs(init).max(),
                               (1, 1, 200))
        init_j = jnp.asarray(np.pad(np.broadcast_to(mono, (1, 2, 200)),
                                    ((0, 0), (0, 0), (0, 56))))
        kw = dict(init_audio=init_j, init_noise_level=0.7,
                  mask_args={"mask": jnp.asarray(mask).reshape(1, 1, -1)})

    def model_apply(x, t, **k):
        return jdit.apply(dparams, x, t, **k)

    want = np.asarray(jg.generate_diffusion_cond(
        model_apply, KEY, steps=4, cfg_scale=3.0, batch_size=1,
        sample_size=256, cond_inputs=jrouting.gather(jcond(cvars, jin)),
        diffusion_objective=objective, sampler_type=c.get("sampler_type"),
        pretransform=jpre, **kw))
    k_noise, _ = jax.random.split(KEY)
    noise = _t(jax.random.normal(k_noise, (1, 3, 64)))
    app = GenerationApp(model=tdit, io_channels=3, sample_size=256,
                        routing=trouting, conditioner=tcond_m,
                        pretransform=tpre)
    got = app.generate_conditional(
        inputs, steps=4, cfg_scale=3.0, sampler_type=c.get("sampler_type"),
        init_audio=init, init_noise_level=0.7, inpaint_mask=mask,
        noise=noise)
    assert got.shape == want.shape == (1, 2, 256)
    assert max_rel(got, want) <= GEN_BAR, max_rel(got, want)
    if case == "v":  # the seed's own noise: the same draw as initial_noise
        a = app.generate_conditional(inputs, steps=2, seed=3)
        b = app.generate_conditional(inputs, steps=2,
                                     noise=app.initial_noise(1, 3))
        np.testing.assert_array_equal(a, b)


def test_jax_generation_app_without_pretransform():
    """JAX's ``GenerationApp`` (latents, no pretransform) against the
    port's on the same noise: the conditional tab and the unconditional
    one (``sample_k`` from the seed's normal draw, peak-normalized)."""
    (cfg, jdit, dparams, jrouting, jcond, cvars, jpre, tdit, trouting,
     tcond_m, tpre) = _built()
    inputs = _cond_inputs()
    jin = {k: ((jnp.asarray(v[0]), jnp.asarray(v[1]))
               if isinstance(v, tuple) else jnp.asarray(v))
           for k, v in inputs.items()}
    japp = JApp(model=jdit, params=dparams, io_channels=3, sample_size=64,
                routing=jrouting, conditioner=jcond, conditioner_vars=cvars)
    app = GenerationApp(model=tdit, io_channels=3, sample_size=64,
                        routing=trouting, conditioner=tcond_m)
    want = japp.generate_conditional(jin, steps=3, cfg_scale=2.0, seed=5)
    k_noise, _ = jax.random.split(jax.random.PRNGKey(5))
    got = app.generate_conditional(
        inputs, steps=3, cfg_scale=2.0,
        noise=_t(jax.random.normal(k_noise, (1, 3, 64))))
    assert max_rel(got, want) <= GEN_BAR
    want = japp.generate_uncond(steps=3, seed=2)
    got = app.generate_uncond(steps=3, noise=_t(jax.random.normal(
        jax.random.PRNGKey(2), (1, 3, 64))))
    assert max_rel(got, want) <= GEN_BAR
