"""The port's FACodec decoder (models/facodec.py) against the JAX
package's on the CPU, at the small config of tests/test_torch_facodec.py:
a seeded flax tree (its paths and shapes those of the port's
``params_to_jax``, held to JAX's ``init`` there) carried across by
``params_from_jax``; the forward with ``return_info`` and every
gradient-reversal head on (the heads at 1e-4 of max|ref|, the audio at
1e-3), the codes exact with the inputs' top-2 cosine margins asserted to
clear 1e-4; ``vq2emb`` and ``decode_with_timbre`` at 1e-3; a train forward
held on JAX's rvq_mask draw; the port's encoder -> decoder round trip
within 1e-3 of JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import vq_margins
from stable_audio_parity import load_jax, max_rel, redraw, unflat

import ditsep_tpu.models.facodec as J
import ditsep_tpu_torch.models.facodec as P
from ditsep_tpu_torch.models.weights import params_to_jax
from test_torch_facodec import (
    D, GR_HEADS, MARGIN, MODULE_TOL, PATH_TOL, SMALL_DEC, _t, _x,
)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_tree(model, seed: int):
    """A flax tree in ``model``'s layout (``params_to_jax``), every leaf
    drawn anew from ``seed``."""
    return redraw({"params": unflat(params_to_jax(model))}, seed)


@pytest.fixture(scope="module")
def encoder_run():
    """The (2, 5) encoder in both packages on seeded audio: JAX's output
    is the decoder's input."""
    x = _x((2, 1, 400), 6)
    je = J.FACodecEncoder(ngf=4, up_ratios=(2, 5), out_channels=D)
    pe = P.FACodecEncoder(ngf=4, up_ratios=(2, 5), out_channels=D)
    tree = seeded_tree(pe, 7)
    h = np.asarray(jax.jit(je.apply)(tree, jnp.asarray(x)))
    return x, h, load_jax(pe, tree)


def train_forward(jd, params, h, key):
    """JAX's ``train=True`` forward and its rvq_mask draw (flax folds the
    module's path into the key: the draw is read off
    ``jax.random.bernoulli`` while the forward traces)."""
    seen, bernoulli = [], jax.random.bernoulli

    def record(*args, **kwargs):
        seen.append(bernoulli(*args, **kwargs))
        return seen[-1]

    jax.random.bernoulli = record
    try:
        audio, info = jd.apply(params, h, train=True, return_info=True,
                               rngs={"rvq_mask": key})
    finally:
        jax.random.bernoulli = bernoulli
    (keep,) = seen
    return audio, info, keep


GR_NAMES = ("prosody_phone_head", "content_f0_head", "res_f0_head",
            "res_phone_head", "x_timbre_head")


@pytest.fixture(scope="module")
def decoder_run(encoder_run):
    """The decoder with every gradient-reversal head on: forward with
    ``return_info``, ``vq2emb`` of its codes, ``decode_with_timbre`` under
    another speaker; and, without those heads (the same tree less them),
    a train forward under JAX's rvq_mask draw. The JAX side in one
    jitted call."""
    _, h, _ = encoder_run
    jd = J.FACodecDecoder(**SMALL_DEC, **GR_HEADS)
    jd_train = J.FACodecDecoder(**SMALL_DEC)
    pd = P.FACodecDecoder(**SMALL_DEC, **GR_HEADS)
    tree = seeded_tree(pd, 8)
    train_tree = {"params": {k: v for k, v in tree["params"].items()
                             if k not in GR_NAMES}}
    spk = _x((2, D), 9, 1.0)

    def jax_side(p, p_train, a, s, key):
        audio, info = jd.apply(p, a, return_info=True)
        emb = jd.apply(p, info["codes"], method=jd.vq2emb)
        vc = jd.apply(p, emb, s, method=jd.decode_with_timbre)
        return (audio, info, emb, vc) + train_forward(jd_train, p_train, a,
                                                      key)

    # its rvq_mask draw keeps one item of the 2
    out = jax.jit(jax_side)(tree, train_tree, jnp.asarray(h),
                            jnp.asarray(spk), jax.random.PRNGKey(0))
    keep = np.array(out[-1])
    load_jax(pd, tree)
    pd_train = load_jax(P.FACodecDecoder(**SMALL_DEC), train_tree)
    with torch.no_grad():
        pa, pinfo = pd(_t(h), return_info=True)
        pemb = pd.vq2emb(pinfo["codes"])
        pvc = pd.decode_with_timbre(pemb, _t(spk))
        ptr, ptr_info = pd_train(_t(h), train=True, return_info=True,
                                 keep=torch.from_numpy(keep))
    return {"h": h, "pd": pd, "jax": out[:6],
            "port": (pa, pinfo, pemb, pvc, ptr, ptr_info), "keep": keep}


def test_codes_clear_the_margin(decoder_run):
    margins = vq_margins(decoder_run["pd"], _t(decoder_run["h"]))
    assert margins.min() > MARGIN


def test_decoder_forward_and_heads(decoder_run):
    ja, jinfo = decoder_run["jax"][:2]
    pa, pinfo = decoder_run["port"][:2]
    assert pa.shape == ja.shape == (2, 1, 400)
    assert max_rel(pa, ja) <= PATH_TOL
    assert np.array_equal(pinfo["codes"].numpy(), np.asarray(jinfo["codes"]))
    assert np.array_equal(pinfo["indices"].numpy(),
                          np.asarray(jinfo["indices"]))
    assert set(pinfo) == set(jinfo)
    for k in ("f0", "uv", "phone", "spk_embs", "prosody_phone",
              "content_f0", "content_uv", "res_f0", "res_uv", "res_phone",
              "x_timbre"):
        assert pinfo[k].shape == jinfo[k].shape, k
        assert max_rel(pinfo[k], jinfo[k]) <= MODULE_TOL, k
    assert float(pinfo["vq_loss"]) == float(jinfo["vq_loss"]) == 0.0


def test_vq2emb_and_decode_with_timbre(decoder_run):
    _, _, jemb, jvc = decoder_run["jax"][:4]
    _, _, pemb, pvc = decoder_run["port"][:4]
    assert pemb.shape == jemb.shape == (2, D, 40)
    assert max_rel(pemb, jemb) <= PATH_TOL
    assert pvc.shape == jvc.shape == (2, 1, 400)
    assert max_rel(pvc, jvc) <= PATH_TOL


def test_train_forward_under_jax_mask(decoder_run):
    """``train=True``: the residual group masked by JAX's rvq_mask draw
    (both kept and dropped items), the VQ losses computed."""
    keep = decoder_run["keep"]
    assert keep.any() and not keep.all()
    jtr, jinfo = decoder_run["jax"][4:]
    ptr, pinfo = decoder_run["port"][4:]
    assert max_rel(ptr, jtr) <= PATH_TOL
    assert float(pinfo["vq_loss"]) > 0
    assert max_rel(pinfo["vq_losses"], jinfo["vq_losses"]) <= MODULE_TOL


def test_round_trip_shapes_and_generator_mask(encoder_run, decoder_run):
    """The port's own encoder into its decoder (the JAX round trip's
    audio within 1e-3), and the train mask drawn from a generator."""
    x, _, pe = encoder_run
    x = _t(x)
    pd = decoder_run["pd"]
    with torch.no_grad():
        audio = pd(pe(x))
    assert audio.shape == x.shape
    assert max_rel(audio, decoder_run["jax"][0]) <= PATH_TOL
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a1 = pd(pe(x), train=True, generator=g)
    assert a1.shape == x.shape and bool(torch.isfinite(a1).all())
