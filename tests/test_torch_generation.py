"""The port's samplers and generation helpers (ditsep_tpu_torch/
inference/{sampling,generation,diffusion_prior,utils}.py) and the model
factory's dispatch against the JAX package's. ``generate_diffusion_cond``
and ``GenerationApp`` through the factory are in
tests/test_torch_generation_app.py.

Every sampler runs a closed-form denoiser on JAX's own noise and draws,
the same step counts, at 1e-5 of max|ref|; the float32 grids are exact,
``build_mask`` exact but its Hann edges (2 ulps of 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.inference import diffusion_prior as jdp
from ditsep_tpu.inference import generation as jg
from ditsep_tpu.inference import sampling as js
from ditsep_tpu_torch.inference import diffusion_prior as tdp
from ditsep_tpu_torch.inference import generation as tg
from ditsep_tpu_torch.inference import sampling as ts
from ditsep_tpu_torch.inference.utils import prepare_audio
from ditsep_tpu_torch.models import factory as tf
from ditsep_tpu_torch.sdes.samplers import _linspace32
from stable_audio_parity import max_rel

SAMPLER_BAR = 1e-5
KEY = jax.random.PRNGKey(7)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_model(x, t, shift=0.0):
    """A closed-form denoiser, the same expression in both packages."""
    tt = t[:, None, None]
    return 0.8 * x * jnp.cos(tt) - 0.3 * jnp.sin(2.0 * x + tt) + shift


def torch_model(x, t, shift=0.0):
    tt = t[:, None, None]
    return 0.8 * x * torch.cos(tt) - 0.3 * torch.sin(2.0 * x + tt) + shift


NOISE = np.asarray(jax.random.normal(KEY, (2, 3, 16)))
INIT = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (2, 3, 16)))


@pytest.mark.parametrize("steps,sigma_max", [(5, 1.0), (4, 0.6), (9, 0.35)])
def test_float32_grids_are_jax_bits(steps, sigma_max):
    """The time grids and the Karras schedule at rho = 1 (the k-heun
    sampler's) are JAX's bits."""
    np.testing.assert_array_equal(
        _linspace32(sigma_max, 0.0, steps + 1),
        np.asarray(jnp.linspace(sigma_max, 0, steps + 1)))
    np.testing.assert_array_equal(
        ts.karras_sigmas(steps, 0.5, 50.0, 1.0),
        np.asarray(js.karras_sigmas(steps, 0.5, 50.0, 1.0)))
    # rho = 7: numpy's float32 power and XLA's part by up to an ulp
    np.testing.assert_array_max_ulp(
        ts.karras_sigmas(steps), np.asarray(js.karras_sigmas(steps)), 1)
    t = np.asarray(jnp.linspace(sigma_max, 0, steps + 1))
    np.testing.assert_allclose(
        ts.distribution_shift_time(t, 333),
        np.asarray(js.distribution_shift_time(jnp.asarray(t), 333)),
        rtol=1e-6, atol=1e-7)


def test_schedule_helpers():
    t = np.linspace(0, 1, 7, dtype=np.float32)
    a, s = ts.get_alphas_sigmas(_t(t))
    ja, jsig = js.get_alphas_sigmas(jnp.asarray(t))
    np.testing.assert_allclose(a.numpy(), ja, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), jsig, atol=1e-6)
    np.testing.assert_allclose(ts.alpha_sigma_to_t(a, s).numpy(),
                               js.alpha_sigma_to_t(ja, jsig), atol=1e-6)
    mask = np.linspace(0, 1, 11, dtype=np.float32)
    for i in range(4):
        np.testing.assert_array_equal(
            ts.get_bmask(i, 4, _t(mask)).numpy(),
            np.asarray(js.get_bmask(i, 4, jnp.asarray(mask))))
    normal = jax.random.normal(KEY, (50,))
    want = js.truncated_logistic_normal_rescaled(KEY, (50,))
    got = ts.truncated_logistic_normal_rescaled((50,), normal=_t(normal))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def _jax_call(fn):
    return np.asarray(jax.jit(fn)())


SAMPLERS = {
    # name: (port call, JAX call)
    "ddim": (lambda: ts.sample(torch_model, _t(NOISE), 5),
             lambda: js.sample(jax_model, jnp.asarray(NOISE), None, 5)),
    "ddim_shift_sigma": (
        lambda: ts.sample(torch_model, _t(NOISE), 4, sigma_max=0.7,
                          dist_shift=True, shift=0.1),
        lambda: js.sample(jax_model, jnp.asarray(NOISE), None, 4,
                          sigma_max=0.7, dist_shift=True, shift=0.1)),
    "ddim_eta": (
        lambda: ts.sample(torch_model, _t(NOISE), 4, eta=0.5, noise=[
            _t(jax.random.normal(k, NOISE.shape))
            for k in jax.random.split(KEY, 4)]),
        lambda: js.sample(jax_model, jnp.asarray(NOISE), KEY, 4, eta=0.5)),
    "euler": (lambda: ts.sample_discrete_euler(torch_model, _t(NOISE), 6),
              lambda: js.sample_discrete_euler(jax_model, jnp.asarray(NOISE),
                                               6)),
    "euler_shift": (
        lambda: ts.sample_discrete_euler(torch_model, _t(NOISE), 5,
                                         sigma_max=0.8, dist_shift=True),
        lambda: js.sample_discrete_euler(jax_model, jnp.asarray(NOISE), 5,
                                         sigma_max=0.8, dist_shift=True)),
    "rk4": (lambda: ts.sample_rk4(torch_model, _t(NOISE), 3),
            lambda: js.sample_rk4(jax_model, jnp.asarray(NOISE), 3)),
    "dpmpp": (lambda: ts.sample_flow_dpmpp(torch_model, _t(NOISE), 6),
              lambda: js.sample_flow_dpmpp(jax_model, jnp.asarray(NOISE),
                                           6)),
    "dpmpp_sigma": (
        lambda: ts.sample_flow_dpmpp(torch_model, _t(NOISE), 4,
                                     sigma_max=0.5),
        lambda: js.sample_flow_dpmpp(jax_model, jnp.asarray(NOISE), 4,
                                     sigma_max=0.5)),
    "k_heun": (lambda: ts.sample_k(torch_model, _t(NOISE), steps=6),
               lambda: js.sample_k(jax_model, jnp.asarray(NOISE), steps=6)),
    "k_heun_init": (
        lambda: ts.sample_k(torch_model, _t(NOISE), steps=4, sigma_min=0.3,
                            sigma_max=20.0, rho=7.0, init_data=_t(INIT)),
        lambda: js.sample_k(jax_model, jnp.asarray(NOISE), steps=4,
                            sigma_min=0.3, sigma_max=20.0, rho=7.0,
                            init_data=jnp.asarray(INIT))),
    **{f"rf_{kind}": (
        lambda kind=kind: ts.sample_rf(torch_model, _t(NOISE),
                                       init_data=_t(INIT), steps=4,
                                       sampler_type=kind, sigma_max=0.6),
        lambda kind=kind: js.sample_rf(jax_model, jnp.asarray(NOISE),
                                       init_data=jnp.asarray(INIT), steps=4,
                                       sampler_type=kind, sigma_max=0.6))
       for kind in ("euler", "rk4", "dpmpp")},
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_jax(name):
    port, ref = SAMPLERS[name]
    want = _jax_call(ref)
    got = port()
    assert got.shape == want.shape
    assert max_rel(got, want) <= SAMPLER_BAR, max_rel(got, want)


def test_sample_returns_the_last_prediction():
    """``sample`` returns the last step's pred (x alpha - v sigma), not the
    state: one step from sigma_max = 1 is -v(x, 1)."""
    got = ts.sample(torch_model, _t(NOISE), 1)
    want = -torch_model(_t(NOISE), torch.ones(2))
    assert np.abs(got.numpy() - want.numpy()).max() <= 1e-6


@pytest.mark.parametrize("args", [
    {"maskstart": 20, "maskend": 80, "softnessL": 5, "softnessR": 10,
     "marination": 0.0},
    {"maskstart": 0, "maskend": 50, "softnessL": 0, "softnessR": 25,
     "marination": 0.3},
    {"maskstart": 33.3, "maskend": 66.7, "softnessL": 12.5,
     "softnessR": 0, "marination": 0.1}])
def test_build_mask_matches_jax(args):
    """The regions are JAX's bits; the Hann edges within 2 ulps of 1
    (XLA's float32 cosine is not correctly rounded: no float32 formula
    on the host gives its bits)."""
    for size in (100, 257):
        got = tg.build_mask(size, args).numpy()
        want = np.asarray(jg.build_mask(size, args))
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_array_equal(got == 1, want == 1)
        assert np.abs(got - want).max() <= 2 * 2.0 ** -23


def test_stereoize_matches_jax():
    """Mono -> stereo through input-concat conditioning, padded to the hop,
    on JAX's initial noise."""
    audio = np.asarray(jax.random.normal(KEY, (2, 1, 13)))

    def jfn(x, t, input_concat_cond=None, **kw):
        return jax_model(x, t) + 0.1 * input_concat_cond

    def tfn(x, t, input_concat_cond=None, **kw):
        return torch_model(x, t) + 0.1 * input_concat_cond

    want = jdp.stereoize(jfn, KEY, jnp.asarray(audio), steps=3,
                         min_input_length=4)
    k_noise, _ = jax.random.split(KEY)
    noise = _t(jax.random.normal(k_noise, (2, 2, 16)))
    got = tdp.stereoize(tfn, _t(audio), steps=3, min_input_length=4,
                        noise=noise)
    assert got.shape == (2, 2, 13)
    assert max_rel(got, want) <= SAMPLER_BAR


def test_prepare_audio():
    a = np.random.default_rng(0).standard_normal((2, 300)).astype(np.float32)
    out = prepare_audio(a, 8000, 16000, 500, 2)
    assert out.shape == (1, 2, 500)
    mono = prepare_audio(a[0], 8000, 8000, 200, 1)
    np.testing.assert_array_equal(mono[0, 0], a[0, :200])


def test_factory_dispatch_and_refusals():
    """Every branch of the factory builds (the codecs, the DAC
    pretransform, the LM, the diffusion autoencoder, DAU1d and the adp
    U-Nets among them), unknown types are refused, and
    ``generate_diffusion_cond``
    runs the 'adp_cfg_1d' U-Net from the factory against JAX's on JAX's
    noise (JAX's adapter refuses the ``scale_phi`` that its generator
    passes every model: the JAX side drops it)."""
    from ditsep_tpu.models import factory as jf
    from ditsep_tpu_torch.models import (codecs, dau1d, diffusion_ae, lm,
                                         pretransforms, unet1d)
    from stable_audio_parity import init_shapes, load_jax, redraw
    vae = tf.create_model_from_config(
        {"model_type": "autoencoder",
         "model": {"encoder": {"type": "oobleck", "config": {
             "channels": 4, "c_mults": [1, 2], "strides": [2, 2],
             "latent_dim": 6}},
             "decoder": {"type": "oobleck", "config": {
                 "channels": 4, "c_mults": [1, 2], "strides": [2, 2],
                 "latent_dim": 3}},
             "bottleneck": {"type": "vae"}, "latent_dim": 3}})
    assert vae.downsampling_ratio == 4 and vae.latent_dim == 3
    dit = tf.create_model_from_config({"model_type": "diffusion_uncond",
                                       "model": {"type": "dit", "config": {
                                           "io_channels": 2, "embed_dim": 16,
                                           "depth": 1, "num_heads": 2}}})
    assert dit.io_channels == 2
    for kind, cls in (("wavelet", "WaveletPretransform"),
                      ("pqmf", "PQMFPretransform"),
                      ("patched", "PatchedPretransform")):
        conf = {"channels": 2, "levels": 2} if kind == "wavelet" else {}
        assert type(tf.create_pretransform_from_config(
            {"type": kind, "config": conf})).__name__ == cls
    for bn in ("vae", "tanh", "l2_norm", "rvq", "rvq_vae", "fsq",
               "wasserstein", "dac_rvq", "dac_rvq_vae"):
        tf.create_bottleneck_from_config({"type": bn, "config": {}})
    tf.create_bottleneck_from_config(
        {"type": "dithered_fsq", "config": {"dim": 4, "levels": 5}})
    codec_cfgs = {
        "dac": ({"d_model": 2, "strides": [2], "latent_dim": 4},
                {"latent_dim": 4, "channels": 4, "rates": [2]}),
        "seanet": ({"dimension": 4, "n_filters": 2, "ratios": [2],
                    "norm": "weight_norm", "causal": False},
                   {"dimension": 4, "n_filters": 2, "ratios": [2],
                    "final_activation": None}),
        "local_attn": ({"in_channels": 1, "out_channels": 4,
                        "embed_dims": [4], "heads": [2], "depths": [1],
                        "ratios": [2], "local_attn_window_size": 4},
                       {"in_channels": 4, "out_channels": 1,
                        "embed_dims": [4], "heads": [2], "depths": [1],
                        "ratios": [2], "local_attn_window_size": 4}),
        "taae": ({"in_channels": 1, "channels": 4, "latent_dim": 4,
                  "c_mults": [1], "strides": [2], "transformer_depths": [1]},
                 {"out_channels": 1, "channels": 4, "latent_dim": 4,
                  "c_mults": [1], "strides": [2],
                  "transformer_depths": [1]})}
    for kind, (enc, dec) in codec_cfgs.items():
        ae = tf.create_model_from_config({"model_type": "autoencoder",
                                          "model": {
            "encoder": {"type": kind, "config": enc},
            "decoder": {"type": kind, "config": dec},
            "bottleneck": {"type": "tanh"}, "latent_dim": 4}})
        assert isinstance(ae, codecs.GenericAudioAutoencoder)
        with torch.no_grad():
            assert ae(torch.zeros(1, 1, 8))[0].shape == (1, 1, 8)
    with torch.device("meta"):
        pre = tf.create_pretransform_from_config({"type": "dac_pretrained"})
    assert isinstance(pre, pretransforms.DACPretransform)
    assert (pre.downsampling_ratio, pre.encoded_channels,
            pre.num_quantizers) == (512, 1024, 9)
    model, pattern = tf.create_model_from_config({"model_type": "lm",
                                                  "model": {"lm": {
        "codebook_pattern": "unroll", "config": {
            "n_quantizers": 2, "codebook_size": 8, "embed_dim": 8,
            "depth": 1, "num_heads": 2}}}})
    assert isinstance(model, lm.AudioLM)
    assert isinstance(pattern, lm.UnrolledPattern)
    dae = tf.create_model_from_config({
        "model_type": "diffusion_autoencoder", "model": {
            "latent_dim": 2, "downsampling_ratio": 4, "io_channels": 1,
            "encoder": {"type": "oobleck", "config": {
                "channels": 2, "c_mults": [1], "strides": [4],
                "latent_dim": 2}},
            "diffusion": {"type": "dit", "config": {
                "io_channels": 3, "embed_dim": 8, "depth": 1,
                "num_heads": 2}}}})
    assert isinstance(dae, diffusion_ae.DiffusionAutoencoder)
    dau = tf.create_model_from_config({"model_type": "diffusion_uncond",
                                       "model": {"type": "DAU1d", "config": {
                                           "io_channels": 1, "depth": 2,
                                           "channels": [4, 4],
                                           "strides": [2]}}})
    assert isinstance(dau, dau1d.DiffusionAttnUnet1D)
    unet_cfg = {"in_channels": 2, "channels": 4, "multipliers": [1, 2],
                "factors": [2], "num_blocks": [1], "attentions": [0, 1],
                "context_embedding_features": 6,
                "context_embedding_max_length": 4, "attention_heads": 2,
                "attention_features": 4}
    adp = tf.create_model_from_config({"model_type": "diffusion_uncond",
                                       "model": {"type": "adp_uncond_1d",
                                                 "config": unet_cfg}})
    assert isinstance(adp, unet1d.UNetCondAdapter)
    for cfg in ({"model_type": "nope"},
                {"model_type": "diffusion_uncond", "model": {"type": "x"}},
                {"model_type": "autoencoder", "model": {
                    "encoder": {"type": "x"}, "decoder": {"type": "dac"}}}):
        with pytest.raises(NotImplementedError):
            tf.create_model_from_config(cfg)
    with pytest.raises(NotImplementedError):
        tf.create_pretransform_from_config({"type": "audiocraft_pretrained"})

    cond_cfg = {"model_type": "diffusion_cond", "model": {"diffusion": {
        "type": "adp_cfg_1d", "cross_attention_cond_ids": ["prompt"],
        "config": unet_cfg}}}
    net, routing, _ = tf.create_model_from_config(cond_cfg)
    jnet = jf.create_model_from_config(cond_cfg)[0]
    emb = np.random.default_rng(0).standard_normal((1, 3, 6)).astype(
        np.float32)
    params = redraw(init_shapes(jnet, jnp.zeros((1, 2, 16)), jnp.zeros((1,)),
                                cross_attn_cond=jnp.asarray(emb)), 1)
    load_jax(net, params)
    kw = {"cross_attn_cond": emb, "cross_attn_cond_mask": np.ones((1, 3),
                                                                  bool)}
    want = jg.generate_diffusion_cond(
        lambda x, t, scale_phi, **k: jnet.apply(params, x, t, **k), KEY,
        steps=3, cfg_scale=2.5, batch_size=1, sample_size=16, io_channels=2,
        cond_inputs={k: jnp.asarray(v) for k, v in kw.items()})
    noise = _t(jax.random.normal(jax.random.split(KEY)[0], (1, 2, 16)))
    with torch.no_grad():
        got = tg.generate_diffusion_cond(
            net, steps=3, cfg_scale=2.5, batch_size=1, sample_size=16,
            io_channels=net.io_channels,
            cond_inputs={k: _t(v) for k, v in kw.items()},
            diffusion_objective=net.diffusion_objective, noise=noise)
    assert max_rel(got, want) <= 1e-3
