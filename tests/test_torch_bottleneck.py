"""The port's bottlenecks, pretransforms and chunked Oobleck codec
(ditsep_tpu_torch/models/{bottleneck,pretransforms,oobleck}.py) against
the JAX package's, on seeded inputs; where a bottleneck samples, the port
takes JAX's own draws (rebuilt from JAX's key in its layout); parameters
are JAX's redrawn from a seed, carried over by ``params_from_jax``.

Bars: bottlenecks and the parameter-free pretransforms 1e-5 of max|ref|,
indices and codes exact; the VAE pretransform and the chunked codec 1e-4
of max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ditsep_tpu.models import bottleneck as jb
from ditsep_tpu.models import oobleck as joob
from ditsep_tpu.models import pretransforms as jp
from ditsep_tpu_torch.models import bottleneck as tb
from ditsep_tpu_torch.models import oobleck as toob
from ditsep_tpu_torch.models import pretransforms as tp
from stable_audio_parity import flat, init_shapes, load_jax, max_rel, redraw

BAR = 1e-5
VAE_BAR = 1e-4
KEY = jax.random.PRNGKey(4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, bar=BAR):
    assert max_rel(got, want) <= bar


def _cl_normal(key, x_cf):
    """JAX's standard-normal draw of a channel-last (B, T, C) tensor, as a
    channel-first (B, C, T) one."""
    z = jax.random.normal(key, np.swapaxes(x_cf, 1, -1).shape)
    return _t(np.swapaxes(np.asarray(z), 1, -1))


def test_tanh_l2_and_fsq():
    x = _x((2, 4, 7), 1) * 2
    for jm, tm in ((jb.TanhBottleneck(2.0), tb.TanhBottleneck(2.0)),
                   (jb.L2Bottleneck(), tb.L2Bottleneck())):
        _close(tm.encode(_t(x)), jm.encode(None, jnp.asarray(x)))
        _close(tm.decode(_t(x)), jm.decode(jnp.asarray(x)))
    jf, tf = jb.FSQBottleneck((8, 5, 5, 4)), tb.FSQBottleneck((8, 5, 5, 4))
    q = tf.encode(_t(x))
    jq = jf.encode(None, jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tf.tokens(q).numpy(),
                                  np.asarray(jf.tokens(jq)))


def test_vae_bottleneck_mode_and_sample():
    x = _x((2, 8, 6), 2)
    jm, tm = jb.VAEBottleneck(), tb.VAEBottleneck()
    _close(tm.encode(_t(x)), jm.encode(None, jnp.asarray(x)))
    want, winfo = jm.encode(KEY, jnp.asarray(x), return_info=True)
    noise = _cl_normal(KEY, x[:, :4])
    got, info = tm.encode(_t(x), return_info=True, noise=noise)
    _close(got, want)
    _close(info["kl"], winfo["kl"])
    g = torch.Generator().manual_seed(0)
    assert tm.encode(_t(x), generator=g).shape == got.shape


def test_wasserstein_mmd_and_noise_augment():
    x = _x((2, 3, 5), 3)
    jm = jb.WassersteinBottleneck(noise_augment_dim=2, use_tanh=True)
    tm = tb.WassersteinBottleneck(noise_augment_dim=2, use_tanh=True)
    want, winfo = jm.encode(KEY, jnp.asarray(x), return_info=True)
    z = np.swapaxes(x, 1, -1).reshape(-1, 3)
    mmd_noise = _t(np.asarray(jax.random.normal(KEY, z.shape)))
    got, info = tm.encode(_t(x), return_info=True, noise=mmd_noise)
    _close(got, want)
    _close(info["mmd"], winfo["mmd"])
    k2 = jax.random.PRNGKey(9)
    aug = jax.random.normal(k2, (2, 2, 5))
    _close(tm.decode(_t(x), noise=_t(aug)), jm.decode(jnp.asarray(x), key=k2))
    with pytest.raises(ValueError, match="generator or noise"):
        tm.decode(_t(x))


def _quantizer_pair(jq, tq, y, seed, **kw):
    variables = redraw(init_shapes(jq, jnp.asarray(y), **kw), seed)
    return variables, load_jax(tq, variables)


def test_rvq_and_rvq_vae():
    x = _x((2, 6, 9), 4)
    jq = jb.ResidualVQ(dim=6, codebook_size=16, num_quantizers=3)
    tq = tb.ResidualVQ(dim=6, codebook_size=16, num_quantizers=3)
    variables, tq = _quantizer_pair(jq, tq, np.swapaxes(x, 1, -1), 5)
    jbn, tbn = jb.RVQBottleneck(jq), tb.RVQBottleneck(tq)
    want, winfo = jbn.encode(variables, jnp.asarray(x), return_info=True)
    got, info = tbn.encode(_t(x), return_info=True)
    _close(got, want)
    np.testing.assert_array_equal(info["quantizer_indices"].numpy(),
                                  np.asarray(winfo["quantizer_indices"]))
    _close(info["quantizer_loss"], winfo["quantizer_loss"])
    codes = info["quantizer_indices"]
    _close(tbn.decode_tokens(codes),
           jbn.decode_tokens(variables, jnp.asarray(codes.numpy())))
    xv = _x((2, 12, 9), 6)
    jv, tv = jb.RVQVAEBottleneck(jq), tb.RVQVAEBottleneck(tq)
    want, winfo = jv.encode(variables, KEY, jnp.asarray(xv),
                            return_info=True)
    got, info = tv.encode(_t(xv), return_info=True,
                          noise=_cl_normal(KEY, xv[:, :6]))
    _close(got, want)
    _close(info["kl"], winfo["kl"])
    np.testing.assert_array_equal(info["quantizer_indices"].numpy(),
                                  np.asarray(winfo["quantizer_indices"]))


@pytest.mark.parametrize("training", [False, True])
def test_dithered_fsq(training):
    """Eval rounds; training takes JAX's Bernoulli and uniform draws."""
    x = _x((3, 6, 5), 7)
    jm = jb.DitheredFSQBottleneck.build(dim=3, levels=[5, 4, 3],
                                        num_codebooks=2, noise_dropout=0.4)
    tm = tb.DitheredFSQBottleneck.build(dim=3, levels=[5, 4, 3],
                                        num_codebooks=2, noise_dropout=0.4)
    want, winfo = jm.encode(KEY, jnp.asarray(x), return_info=True,
                            training=training)
    draws = None
    if training:
        k1, k2, k3 = jax.random.split(KEY, 3)
        mshape, zshape = (3, 1, 1, 1), (3, 5, 2, 3)
        draws = {"keep": _t(jax.random.bernoulli(k1, 0.4, mshape)),
                 "keep2": _t(jax.random.bernoulli(k2, 0.4, mshape)),
                 "uniform": _t(jax.random.uniform(k3, zshape))}
    got, info = tm.encode(_t(x), return_info=True, training=training,
                          draws=draws)
    _close(got, want)
    np.testing.assert_array_equal(info["quantizer_indices"].numpy(),
                                  np.asarray(winfo["quantizer_indices"]))
    tokens = info["quantizer_indices"]
    _close(tm.decode_tokens(tokens),
           jm.decode_tokens(jnp.asarray(tokens.numpy())))
    with pytest.raises(ValueError, match="Length of levels"):
        tb.DitheredFSQBottleneck.build(dim=2, levels=[3, 3, 3])


@pytest.mark.parametrize("vae,on_decode", [(False, False), (False, True),
                                           (True, False)])
def test_dac_rvq(vae, on_decode):
    x = _x((2, 16 if vae else 8, 7), 8)
    jq = jb.DACResidualVQ(input_dim=8, n_codebooks=3, codebook_size=12,
                          codebook_dim=4)
    tq = tb.DACResidualVQ(input_dim=8, n_codebooks=3, codebook_size=12,
                          codebook_dim=4)
    variables, tq = _quantizer_pair(jq, tq, np.swapaxes(x[:, :8], 1, -1), 9)
    if vae:
        jm = jb.DACRVQVAEBottleneck(jq, quantize_on_decode=on_decode)
        tm = tb.DACRVQVAEBottleneck(tq, quantize_on_decode=on_decode)
        want, winfo = jm.encode(variables, KEY, jnp.asarray(x),
                                return_info=True)
        got, info = tm.encode(_t(x), return_info=True,
                              noise=_cl_normal(KEY, x[:, :8]))
        _close(info["kl"], winfo["kl"])
    else:
        jm = jb.DACRVQBottleneck(jq, quantize_on_decode=on_decode,
                                 noise_augment_dim=2)
        tm = tb.DACRVQBottleneck(tq, quantize_on_decode=on_decode,
                                 noise_augment_dim=2)
        want, winfo = jm.encode(variables, jnp.asarray(x), return_info=True)
        got, info = tm.encode(_t(x), return_info=True)
    _close(got, want)
    for k in winfo:
        if k == "codes":
            np.testing.assert_array_equal(info[k].numpy(),
                                          np.asarray(winfo[k]))
        else:
            _close(info[k], winfo[k])
    if vae:
        _close(tm.decode(got), jm.decode(variables, want))
    else:
        k2 = jax.random.PRNGKey(3)
        aug = jax.random.normal(k2, (2, 2, 7))
        _close(tm.decode(got, noise=_t(aug)),
               jm.decode(variables, want, key=k2))
    if not on_decode:
        codes = info["codes"]
        if vae:
            _close(tm.decode_tokens(codes),
                   jm.decode_tokens(variables, jnp.asarray(codes.numpy())))
        else:
            _close(tm.quantizer.from_codes(codes),
                   jq.from_codes(variables, jnp.asarray(codes.numpy())))


def test_parameter_free_pretransforms_round_trip():
    x = _x((2, 2, 64), 10)
    for jm, tm in ((jp.WaveletPretransform(2, 3), tp.WaveletPretransform(2, 3)),
                   (jp.PatchedPretransform(2, 4), tp.PatchedPretransform(2, 4)),
                   (jp.PQMFPretransform(4, 16), tp.PQMFPretransform(4, 16))):
        z = tm.encode(_t(x))
        jz = jm.encode(jnp.asarray(x))
        _close(z, jz)
        assert tm.downsampling_ratio == jm.downsampling_ratio
        _close(tm.decode(z), jm.decode(jz))
    for m in (tp.WaveletPretransform(2, 3), tp.PatchedPretransform(2, 4)):
        np.testing.assert_allclose(m.decode(m.encode(_t(x))).numpy(), x,
                                   atol=1e-5)


VAE = dict(in_channels=2, out_channels=2, channels=4, latent_dim=3,
           c_mults=(1, 2), strides=(2, 2), use_snake=True)


def _vae_pair(seed=11):
    """JAX's own initialisation (torch's conv init, g = ||v||): random
    weight-norm gains would drive the decoder's tanh into saturation,
    where float32 rounding of the large pre-activations decides the
    output."""
    jv = joob.OobleckVAE(**VAE)
    params = jax.jit(jv.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 16)))
    params = jax.tree_util.tree_map(np.asarray, params)
    tv = load_jax(toob.OobleckVAE(**VAE), params)
    return jv, params, tv


@pytest.mark.parametrize("chunked", [False, True])
def test_autoencoder_pretransform(chunked):
    """Encode (the mode, and a posterior sample on JAX's draws) and decode
    with a scale (the JAX side jitted, its parameters as arguments; the
    pretransform's chunks are 128 latent frames, so these 20 take one)."""
    jv, params, tv = _vae_pair()
    x = _x((2, 2, 80), 12)  # 20 latent frames
    tpre = tp.AutoencoderPretransform(tv, scale=1.5, chunked=chunked)
    assert (tpre.encoded_channels, tpre.io_channels) == (3, 2)
    noise = _cl_normal(KEY, np.zeros((2, 3, 20), np.float32))

    def jax_side(p, x, key):
        pre = jp.AutoencoderPretransform(jv, p, scale=1.5, chunked=chunked)
        z = pre.encode(x)
        return z, pre.decode(z), pre.encode(x, key=key)

    want = jax.jit(jax_side)(params, jnp.asarray(x), KEY)
    with torch.no_grad():
        z = tpre.encode(_t(x))
        got = (z, tpre.decode(z), tpre.encode(_t(x), noise=noise))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, VAE_BAR)
    assert not any(p.requires_grad for p in tpre.parameters())


def test_chunked_codec():
    """``encode_audio_chunked`` / ``decode_audio_chunked`` over 4 chunks of
    8 latent frames overlapping by 4: the mode, a posterior sample on
    JAX's draws ((B * 4, 3, 8)), the decode of 20 latent frames."""
    jv, params, tv = _vae_pair()
    x = _x((2, 2, 80), 13)
    kw = dict(overlap=4, chunk_size=8)

    def jax_side(p, x, key):
        z = joob.encode_audio_chunked(jv, p, x, **kw)
        return (z, joob.decode_audio_chunked(jv, p, z, **kw),
                joob.encode_audio_chunked(jv, p, x, key=key, **kw))

    want = jax.jit(jax_side)(params, jnp.asarray(x), KEY)
    noise = _cl_normal(KEY, np.zeros((8, 3, 8), np.float32))
    with torch.no_grad():
        z = toob.encode_audio_chunked(tv, _t(x), **kw)
        got = (z, toob.decode_audio_chunked(tv, z, **kw),
               toob.encode_audio_chunked(tv, _t(x), noise=noise, **kw))
    assert got[1].shape == (2, 2, 80)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, VAE_BAR)


def test_dac_pretransform_raises():
    """The DAC pretransform, which raised before the codecs were ported:
    a token round trip (``tokenize`` then ``decode_tokens``) against
    JAX's, codes exact, audio at the VAE bar."""
    from ditsep_tpu.models import codecs as jc
    from ditsep_tpu_torch.models import codecs as tc
    enc_kw = dict(d_model=2, strides=(2,))
    dec_kw = dict(latent_dim=4, channels=4, rates=(2,))
    q_kw = dict(input_dim=4, n_codebooks=2, codebook_size=6, codebook_dim=3)
    lat = jnp.zeros((1, 3, 4))
    params = {"encoder": redraw(init_shapes(jc.DACEncoderWrapper(**enc_kw),
                                            jnp.zeros((1, 6, 1))), 1),
              "decoder": redraw(init_shapes(jc.DACDecoderWrapper(**dec_kw),
                                            lat), 2),
              "quantizer": redraw(init_shapes(jb.DACResidualVQ(**q_kw),
                                              lat), 3, scale=1.0)}
    jpre = jp.DACPretransform(encoder=jc.DACEncoderWrapper(**enc_kw),
                              decoder=jc.DACDecoderWrapper(**dec_kw),
                              quantizer=jb.DACResidualVQ(**q_kw),
                              params=params)
    parts = [load_jax(m, params[k]) for m, k in (
        (tc.DACEncoderWrapper(**enc_kw), "encoder"),
        (tc.DACDecoderWrapper(**dec_kw), "decoder"),
        (tb.DACResidualVQ(**q_kw), "quantizer"))]
    tpre = tp.DACPretransform(*parts)
    x = _x((2, 1, 16), 4)
    codes = jax.jit(jpre.tokenize)(jnp.asarray(x))
    with torch.no_grad():
        got = tpre.tokenize(_t(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(codes))
        _close(tpre.decode_tokens(got), jax.jit(jpre.decode_tokens)(codes),
               VAE_BAR)


def test_bottleneck_params_cross_both_ways():
    """A residual VQ's parameters through ``params_to_jax`` are the JAX
    tree they came from."""
    from ditsep_tpu_torch.models.weights import params_to_jax
    jq = jb.DACResidualVQ(input_dim=8, n_codebooks=2, codebook_size=4,
                          codebook_dim=3)
    tq = tb.DACResidualVQ(input_dim=8, n_codebooks=2, codebook_size=4,
                          codebook_dim=3)
    variables, tq = _quantizer_pair(jq, tq, np.zeros((1, 2, 8), np.float32),
                                    1)
    back = params_to_jax(tq)
    want = {k[len("params/"):]: v for k, v in flat(variables).items()}
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
