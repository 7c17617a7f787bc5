"""The port's codecs (ditsep_tpu_torch/models/codecs.py) and
``DACPretransform`` against the JAX package's (ditsep_tpu/models/codecs.py,
pretransforms.py) on seeded inputs, the JAX parameters redrawn from a seed
and carried over by ``params_from_jax(flat, module)`` (the Oobleck blocks'
``flax_names``, the weight norms' ``v`` / ``g``, the LSTM's eight kernels).

The JAX modules run channel-last (B, T, C), the port's channel-first (B,
C, T): inputs and outputs are transposed between them. Bars: encoders,
decoders, the latents and the decode of JAX's latents 1e-4 of max|ref|;
an autoencoder's whole round trip, a pipeline, 1e-3 (its decoder carries
the latents' float32 rounding on: seeded DAC weights amplify it about
300-fold); codes exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import bottleneck as jb
from ditsep_tpu.models import codecs as jc
from ditsep_tpu.models import pretransforms as jp
from ditsep_tpu_torch.models import bottleneck as tb
from ditsep_tpu_torch.models import codecs as tc
from ditsep_tpu_torch.models import pretransforms as tp
from ditsep_tpu_torch.models.weights import params_to_jax
from stable_audio_parity import (flat, init_shapes, load_jax, max_rel,
                                 redraw)

MODEL_BAR = 1e-4
PIPELINE_BAR = 1e-3
KEY = jax.random.PRNGKey(3)


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


TAAE = dict(channels=4, latent_dim=6, c_mults=(1, 2), strides=(2, 2),
            transformer_depths=(1, 1), sliding_window=(3, 3))
LOCAL = dict(heads=(2, 2), depths=(1, 1), ratios=(2, 2),
             local_attn_window_size=4)

# name: (JAX module, port module, input (B, C, T))
CODECS = {
    "dac_encoder": lambda: (
        jc.DACEncoderWrapper(d_model=4, strides=(2, 4), latent_dim=6),
        tc.DACEncoderWrapper(d_model=4, strides=(2, 4), latent_dim=6),
        (2, 1, 32)),
    "dac_decoder": lambda: (
        jc.DACDecoderWrapper(latent_dim=6, channels=16, rates=(4, 2)),
        tc.DACDecoderWrapper(latent_dim=6, channels=16, rates=(4, 2)),
        (2, 6, 5)),
    "seanet_encoder": lambda: (
        jc.SEANetEncoder(dimension=6, n_filters=4, ratios=(3, 2),
                         n_residual_layers=2),
        tc.SEANetEncoder(dimension=6, n_filters=4, ratios=(3, 2),
                         n_residual_layers=2),
        (2, 1, 36)),
    "seanet_decoder": lambda: (
        jc.SEANetDecoder(dimension=6, n_filters=4, ratios=(3, 2),
                         true_skip=True, lstm=1),
        tc.SEANetDecoder(dimension=6, n_filters=4, ratios=(3, 2),
                         true_skip=True, lstm=1),
        (2, 6, 6)),
    "taae_encoder": lambda: (
        jc.TAAEEncoder(in_channels=1, use_snake=True, use_dilated_conv=True,
                       **TAAE),
        tc.TAAEEncoder(in_channels=1, use_snake=True, use_dilated_conv=True,
                       **TAAE),
        (2, 1, 24)),
    "taae_decoder": lambda: (
        jc.TAAEDecoder(out_channels=1, conformer=True, **TAAE),
        tc.TAAEDecoder(out_channels=1, conformer=True, **TAAE),
        (2, 6, 6)),
    "taae_encoder_no_layer_scale": lambda: (
        jc.TAAEEncoder(in_channels=1, layer_scale=False, **TAAE),
        tc.TAAEEncoder(in_channels=1, layer_scale=False, **TAAE),
        (2, 1, 24)),
    "local_encoder": lambda: (
        jc.LocalTransformerEncoder1D(1, 6, embed_dims=(8, 16), **LOCAL),
        tc.LocalTransformerEncoder1D(1, 6, embed_dims=(8, 16), **LOCAL),
        (2, 1, 24)),
    "local_decoder": lambda: (
        jc.LocalTransformerDecoder1D(6, 1, embed_dims=(16, 8), **LOCAL),
        tc.LocalTransformerDecoder1D(6, 1, embed_dims=(16, 8), **LOCAL),
        (2, 6, 6)),
}


def _pair(jm, tm, x, seed):
    params = redraw(init_shapes(jm, _nwc(x)), seed)
    load_jax(tm, params)
    return params


@pytest.mark.parametrize("name", sorted(CODECS))
def test_codec_matches_jax(name):
    jm, tm, shape = CODECS[name]()
    x = _x(shape, 1)
    params = _pair(jm, tm, x, 2)
    want = np.swapaxes(np.asarray(jax.jit(jm.apply)(params, _nwc(x))), 1, 2)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    assert max_rel(got, want) <= MODEL_BAR
    # the parameters cross back to the JAX tree they came from
    back = params_to_jax(tm)
    want_flat = {k[len("params/"):]: v for k, v in flat(params).items()}
    assert set(back) == set(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_slstm_is_flax_lstm():
    """Two stacked flax OptimizedLSTMCells through torch.lstm (hidden
    bias, zero input bias, gates i f g o), skip added."""
    jm, tm = jc.SLSTM(8, num_layers=2), tc.SLSTM(8, num_layers=2)
    x = _x((3, 11, 8), 4)
    params = redraw(init_shapes(jm, jnp.asarray(x)), 5, scale=1.0)
    load_jax(tm, params)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert max_rel(got, want) <= MODEL_BAR


GENERIC = {
    "vae_dac": dict(bottleneck="vae", enc=("dac", 12), dec="dac"),
    "rvq_seanet": dict(bottleneck="rvq", enc=("seanet", 6), dec="seanet"),
    "tanh_soft_clip_taae": dict(bottleneck="tanh", enc=("taae", 6),
                                dec="taae", soft_clip=True),
    "l2_local": dict(bottleneck="l2_norm", enc=("local", 6), dec="local"),
}


def _generic_parts(kind, pkg, enc_out):
    if kind == "dac":
        return (pkg.DACEncoderWrapper(d_model=4, strides=(2, 2),
                                      latent_dim=enc_out),
                pkg.DACDecoderWrapper(latent_dim=6, channels=8, rates=(2, 2)))
    if kind == "seanet":
        return (pkg.SEANetEncoder(dimension=enc_out, n_filters=4,
                                  ratios=(2, 2), lstm=1),
                pkg.SEANetDecoder(dimension=6, n_filters=4, ratios=(2, 2),
                                  lstm=1))
    if kind == "taae":
        return (pkg.TAAEEncoder(in_channels=1, **TAAE),
                pkg.TAAEDecoder(out_channels=1, **TAAE))
    return (pkg.LocalTransformerEncoder1D(1, enc_out, embed_dims=(8, 16),
                                          **LOCAL),
            pkg.LocalTransformerDecoder1D(6, 1, embed_dims=(16, 8), **LOCAL))


@pytest.mark.parametrize("case", sorted(GENERIC))
def test_generic_autoencoder_matches_jax(case):
    c = GENERIC[case]
    kind, enc_out = c["enc"]
    bn_cfg = ({"dim": 6, "codebook_size": 5, "num_quantizers": 2}
              if c["bottleneck"] == "rvq" else None)
    kw = dict(latent_dim=6, bottleneck_type=c["bottleneck"],
              bottleneck_config=bn_cfg, soft_clip=c.get("soft_clip", False))
    jm = jc.GenericAudioAutoencoder(*_generic_parts(kind, jc, enc_out), **kw)
    tm = tc.GenericAudioAutoencoder(*_generic_parts(kind, tc, enc_out), **kw)
    x = _x((2, 1, 24), 6)
    params = redraw(init_shapes(jm, jnp.asarray(x)), 7)
    load_jax(tm, params)
    vae = c["bottleneck"] == "vae"
    wy, winfo = jax.jit(lambda p, a: jm.apply(
        p, a, key=KEY if vae else None))(params, jnp.asarray(x))
    noise = None
    if vae:  # JAX's draw of the (B, Tl, D) posterior, channel-first
        z = jax.random.normal(KEY, (2, 6, 6))
        noise = torch.from_numpy(np.swapaxes(np.asarray(z), 1, 2).copy())
    with torch.no_grad():
        y, info = tm(torch.from_numpy(x), noise=noise)
        mode = tm.encode(torch.from_numpy(x))
        dec = tm.decode(torch.from_numpy(np.array(winfo["latents"])))
    assert max_rel(info["latents"], winfo["latents"]) <= MODEL_BAR
    assert max_rel(dec, wy) <= MODEL_BAR
    assert max_rel(y, wy) <= PIPELINE_BAR
    if vae:
        assert max_rel(info["kl"], winfo["kl"]) <= MODEL_BAR
        want_mode = jax.jit(lambda p, a: jm.apply(p, a, method=jm.encode))(
            params, jnp.asarray(x))
        assert max_rel(mode, want_mode) <= MODEL_BAR
    if c["bottleneck"] == "rvq":
        np.testing.assert_array_equal(info["codes"].numpy(),
                                      np.asarray(winfo["codes"]))
        assert max_rel(info["quantizer_loss"],
                       winfo["quantizer_loss"]) <= MODEL_BAR
    assert tm.downsampling_ratio == jm.downsampling_ratio == 4


def test_dac_pretransform_matches_jax():
    """``tokenize`` codes exact; ``decode_tokens``, and ``encode`` /
    ``decode`` with and without ``quantize_on_decode``, at the model
    bar."""
    import dataclasses

    enc_kw = dict(d_model=4, strides=(2, 2))
    dec_kw = dict(latent_dim=16, channels=16, rates=(2, 2))
    q_kw = dict(input_dim=16, n_codebooks=3, codebook_size=8, codebook_dim=4)
    je, jd, jq = (jc.DACEncoderWrapper(**enc_kw),
                  jc.DACDecoderWrapper(**dec_kw), jb.DACResidualVQ(**q_kw))
    te, td, tq = (tc.DACEncoderWrapper(**enc_kw),
                  tc.DACDecoderWrapper(**dec_kw), tb.DACResidualVQ(**q_kw))
    lat = jnp.zeros((1, 3, 16))
    params = {"encoder": redraw(init_shapes(je, jnp.zeros((1, 12, 1))), 8),
              "decoder": redraw(init_shapes(jd, lat), 9),
              "quantizer": redraw(init_shapes(jq, lat), 10, scale=1.0)}
    for m, name in ((te, "encoder"), (td, "decoder"), (tq, "quantizer")):
        load_jax(m, params[name])
    jpre = jp.DACPretransform(encoder=je, decoder=jd, quantizer=jq,
                              params=params, scale=1.5)
    tpre = tp.DACPretransform(te, td, tq, scale=1.5)
    x = _x((2, 1, 32), 11)
    codes = np.asarray(jax.jit(jpre.tokenize)(jnp.asarray(x)))
    with torch.no_grad():
        got = tpre.tokenize(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), codes)
        assert got.shape == (2, 3, 8)
        assert max_rel(tpre.decode_tokens(got), jax.jit(jpre.decode_tokens)(
            jnp.asarray(codes))) <= MODEL_BAR
        for on_decode in (True, False):
            j = dataclasses.replace(jpre, quantize_on_decode=on_decode)
            tpre.quantize_on_decode = on_decode
            z = tpre.encode(torch.from_numpy(x))
            assert max_rel(z, jax.jit(j.encode)(jnp.asarray(x))) <= MODEL_BAR
            zz = _x(tuple(z.shape), 12)
            assert max_rel(tpre.decode(torch.from_numpy(zz)), jax.jit(
                j.decode)(jnp.asarray(zz))) <= MODEL_BAR
    assert (tpre.downsampling_ratio, tpre.encoded_channels,
            tpre.num_quantizers, tpre.codebook_size) == (4, 16, 3, 8)
    assert not any(p.requires_grad for p in tpre.parameters())
