"""The port's FACodec (models/facodec.py) and the repaired
``WNConvTranspose1d`` (``output_padding``) against the JAX package's on the
CPU, with the same numpy-seeded inputs and flax trees carried across by
``params_from_jax``: the Kaiser taps bit for bit; the alias-free FIRs at
1e-5 abs; the gradient reversal's gradient equal to ``jax.vjp``'s; the
modules at 1e-4 of max|ref|; the encoder -> decoder round trip, ``vq2emb``
and ``decode_with_timbre`` at 1e-3 of max|ref|, the codes exact (the
inputs' top-2 cosine margins asserted to clear 1e-4). Small config: ngf 4,
up_ratios (2, 5) and its reverse, in_channels 32, timbre 2 layers x 2
heads (filter 64 alone), codebook 16 x 4, 7 phones,
upsample_initial_channel 64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_parity import flat, init_shapes, load_jax, max_rel, redraw

import ditsep_tpu.models.facodec as J
import ditsep_tpu.models.oobleck as JO
import ditsep_tpu_torch.models.facodec as P
from ditsep_tpu_torch.models.oobleck import WNConvTranspose1d
from ditsep_tpu_torch.models.weights import params_from_jax, params_to_jax

OPS_TOL = 1e-5      # abs, the FIR ops
MODULE_TOL = 1e-4   # of max|ref|, a module
PATH_TOL = 1e-3     # of max|ref|, the round trip, vq2emb, decode_with_timbre
MARGIN = 1e-4       # the top-2 cosine margin the codes must clear
D = 32
SMALL_DEC = dict(in_channels=D, ngf=4, up_ratios=(5, 2),
                 upsample_initial_channel=64, codebook_size=16,
                 codebook_dim=4, phone_classes=7, timbre_layers=2,
                 timbre_heads=2)
GR_HEADS = dict(use_gr_content_f0=True, use_gr_prosody_phone=True,
                use_gr_residual_f0=True, use_gr_residual_phone=True,
                use_gr_x_timbre=True, num_speakers=3)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _nwc(a):
    return jnp.asarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("cutoff,half_width,k", [
    (0.25, 0.3, 12), (0.25, 0.3, 13), (0.5 / 3, 0.6 / 3, 18),
    (0.2, 0.1, 24), (0.0, 0.3, 12)])
def test_kaiser_taps_bit_equal(cutoff, half_width, k):
    assert np.array_equal(P.kaiser_sinc_filter1d(cutoff, half_width, k),
                          J.kaiser_sinc_filter1d(cutoff, half_width, k))


@pytest.mark.parametrize("op", ["lowpass", "up2", "down2", "up3", "down3"])
def test_fir_ops(op):
    x = _x((2, 3, 37), 1)
    fns = {"lowpass": (lambda m, a: m.lowpass_filter1d(
               a, cutoff=0.2, half_width=0.1, kernel_size=24)),
           "up2": lambda m, a: m.upsample1d(a, 2),
           "down2": lambda m, a: m.downsample1d(a, 2),
           "up3": lambda m, a: m.upsample1d(a, 3),
           "down3": lambda m, a: m.downsample1d(a, 3)}
    want = np.swapaxes(np.asarray(fns[op](J, _nwc(x))), 1, 2)
    got = fns[op](P, _t(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= OPS_TOL


def test_gradient_reversal_gradient_equals_jax_vjp():
    x, g = _x((2, 5), 2), _x((2, 5), 3)
    _, vjp = jax.vjp(lambda a: J.gradient_reversal(a, 3.0), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    y = P.gradient_reversal(xt, 3.0)
    assert torch.equal(y, xt.detach())
    y.backward(_t(g))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride", [2, 4, 5])
def test_wn_conv_transpose_output_padding(stride):
    """The transposed conv of a FACodec decoder block (kernel 2s, padding
    ceil(s / 2), output_padding s % 2): T s samples out at every stride,
    equal to JAX's, and back through ``params_to_jax`` bit for bit."""
    s, t = stride, 9
    jm = JO.WNConvTranspose1d(6, 2 * s, stride=s, padding=-(-s // 2),
                              output_padding=s % 2)
    x = _x((2, t, 4), 4)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 5)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    pm = WNConvTranspose1d(4, 6, 2 * s, stride=s, padding=-(-s // 2),
                           output_padding=s % 2)
    load_jax(pm, tree)
    with torch.no_grad():
        got = pm(_t(np.swapaxes(x, 1, 2))).numpy()
    assert want.shape == (2, t * s, 6) and got.shape == (2, 6, t * s)
    assert max_rel(np.swapaxes(got, 1, 2), want) <= MODULE_TOL
    want_tree = {k.split("params/", 1)[-1]: v for k, v in flat(tree).items()}
    back = params_to_jax(pm)
    assert back.keys() == want_tree.keys()
    assert all(np.array_equal(back[k], v) for k, v in want_tree.items())


@pytest.fixture(scope="module")
def encoder_run():
    """Both encoders, (2, 5) and (5, 2), on the same seeded audio and
    trees; the decoder's input is the (2, 5) encoder's output."""
    x = _x((2, 1, 400), 6)
    out = {}
    for ratios in ((2, 5), (5, 2)):
        je = J.FACodecEncoder(ngf=4, up_ratios=ratios, out_channels=D)
        tree = redraw(init_shapes(je, jnp.asarray(x)), 7)
        want = np.asarray(jax.jit(lambda p, a: je.apply(p, a))(
            tree, jnp.asarray(x)))
        pe = load_jax(P.FACodecEncoder(ngf=4, up_ratios=ratios,
                                       out_channels=D), tree)
        with torch.no_grad():
            got = pe(_t(x)).numpy()
        out[ratios] = (want, got, pe)
    return x, out


@pytest.mark.parametrize("ratios", [(2, 5), (5, 2)])
def test_encoder(encoder_run, ratios):
    _, out = encoder_run
    want, got, pe = out[ratios]
    assert want.shape == got.shape == (2, D, 40) and pe.hop_length == 10
    assert max_rel(got, want) <= MODULE_TOL


def test_timbre_encoder_filter_64():
    jm = J.FacodecTimbreEncoder(hidden=D, num_layers=2, num_heads=2,
                                filter_size=64)
    x = _x((3, 11, D), 10, 1.0)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 11)
    want = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    pm = load_jax(P.FacodecTimbreEncoder(hidden=D, num_layers=2,
                                         num_heads=2, filter_size=64), tree)
    with torch.no_grad():
        got = pm(_t(x))
    assert max_rel(got, want) <= MODULE_TOL


def test_factorized_vq_codes_and_lookup():
    jm = J.FacodecRVQ(2, D, 16, 4)
    x = _x((2, 13, D), 12, 1.0)
    tree = redraw(init_shapes(jm, jnp.asarray(x)), 13)
    jq, jc, jl = jax.jit(lambda p, a: (
        *jm.apply(p, a)[:2], jm.apply(p, jm.apply(p, a)[1],
                                      method=jm.lookup)))(tree, jnp.asarray(x))
    pm = load_jax(P.FacodecRVQ(2, D, 16, 4), tree)
    with torch.no_grad():
        pq, pc, _ = pm(_t(x))
        pl = pm.lookup(pc)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert max_rel(pq, jq) <= MODULE_TOL
    assert max_rel(pl, jl) <= MODULE_TOL


def test_weights_round_trip_and_seeding():
    """``params_to_jax`` of a seeded decoder is its flax tree (paths and
    shapes as JAX's ``init``), the FiLM starting at gamma 1, beta 0."""
    pd = P.FACodecDecoder(**SMALL_DEC)
    pd.reset_parameters(torch.Generator().manual_seed(0))
    back = params_to_jax(pd)
    jd = J.FACodecDecoder(**SMALL_DEC)
    shapes = {k.split("params/", 1)[-1]: v.shape for k, v in flat(
        init_shapes(jd, jnp.zeros((1, D, 4)), return_info=True)).items()}
    assert {k: v.shape for k, v in back.items()} == shapes
    assert np.array_equal(back["timbre_film/bias"],
                          np.r_[np.ones(D), np.zeros(D)].astype(np.float32))
    again = P.FACodecDecoder(**SMALL_DEC)
    again.load_state_dict(params_from_jax(back, again))
    assert all(torch.equal(a, b) for a, b in zip(
        again.state_dict().values(), pd.state_dict().values()))
