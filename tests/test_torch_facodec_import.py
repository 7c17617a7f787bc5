"""The port's FACodec importer (models/facodec_import.py) and demo CLI
(cli/facodec_demo.py) against the JAX package's on the CPU, at the small
config of tests/test_torch_facodec.py.

The importer: one synthetic state dict in the reference's key layout
(``weight_v`` / ``weight_g``, the ``nn.Sequential`` indices, torch
MultiheadAttention's fused ``in_proj``, every gradient-reversal head on,
the alias-free FIR and positional-table buffers beside them) goes through
JAX's ``import_facodec_encoder`` / ``import_facodec_decoder`` and through
the port's: JAX's trees are the seeded tree the dict was written from,
the port's weights are JAX's bit for bit through ``params_from_jax``, the
outputs agree at the bars of tests/test_torch_facodec.py (codes exact);
a decoder built at another codebook size takes the dict's; an unknown or
a missing key raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stable_audio_parity import flat, load_jax, max_rel, redraw, unflat

import ditsep_tpu.models.facodec as J
import ditsep_tpu_torch.models.facodec as P
from ditsep_tpu.models.facodec_import import (
    import_facodec_decoder as jax_import_decoder,
    import_facodec_encoder as jax_import_encoder,
)
from ditsep_tpu_torch.models.facodec_import import (
    facodec_decoder_key_map, facodec_encoder_key_map,
    import_facodec_decoder, import_facodec_encoder,
)
from ditsep_tpu_torch.models.weights import params_from_jax, params_to_jax
from test_torch_facodec import (
    D, GR_HEADS, MODULE_TOL, PATH_TOL, SMALL_DEC, _t, _x,
)

SMALL_ENC = dict(ngf=4, up_ratios=(2, 5), out_channels=D)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reference_state(model, key_map, seed: int) -> dict:
    """A reference-layout state dict of ``model``'s weights (seeded anew,
    each leaf distinct), with the reference's buffers: each alias-free
    activation's up / down FIR taps and the timbre encoder's table."""
    load_jax(model, redraw({"params": unflat(params_to_jax(model))}, seed))
    state = model.state_dict()
    sd = {ref: state[port].clone() for ref, port in key_map.items()}
    for ref in list(sd):
        if ref.endswith(".act.alpha"):
            act = ref[:-len(".act.alpha")]
            sd[f"{act}.upsample.filter"] = torch.ones(1, 1, 12)
            sd[f"{act}.downsample.lowpass.filter"] = torch.ones(1, 1, 12)
    if any(k.startswith("timbre_encoder.") for k in sd):
        sd["timbre_encoder.position_emb.pe"] = torch.zeros(5000, 1, D)
    return sd


def _equal_trees(jax_params, port_model) -> bool:
    want = params_from_jax(flat(jax_params), port_model)
    got = port_model.state_dict()
    return want.keys() == got.keys() and all(
        torch.equal(want[k], got[k]) for k in want)


@pytest.fixture(scope="module")
def imported():
    src_enc = P.FACodecEncoder(**SMALL_ENC)
    src_dec = P.FACodecDecoder(**SMALL_DEC, **GR_HEADS)
    sd_enc = reference_state(src_enc, facodec_encoder_key_map(2), 1)
    sd_dec = reference_state(src_dec, facodec_decoder_key_map(src_dec), 2)
    jd = J.FACodecDecoder(**SMALL_DEC, **GR_HEADS)
    jp_enc = jax_import_encoder(sd_enc)
    jp_dec = jax_import_decoder(sd_dec, jd)
    enc = import_facodec_encoder(sd_enc, P.FACodecEncoder(**SMALL_ENC))
    dec = import_facodec_decoder(
        sd_dec, P.FACodecDecoder(**{**SMALL_DEC, "codebook_size": 8,
                                    "codebook_dim": 2}, **GR_HEADS)).eval()
    x = _x((2, 1, 400), 3)
    je = J.FACodecEncoder(**SMALL_ENC)
    jh, ja, jinfo = jax.jit(lambda pe, pd, a: (
        lambda h: (h, *jd.apply(pd, h, return_info=True)))(
            je.apply(pe, a)))(jp_enc, jp_dec, jnp.asarray(x))
    with torch.no_grad():
        ph = enc(_t(x))
        pa, pinfo = dec(ph, return_info=True)
    return dict(src=(src_enc, src_dec), sd=(sd_enc, sd_dec),
                jax_params=(jp_enc, jp_dec), port=(enc, dec),
                jax_out=(jh, ja, jinfo), port_out=(ph, pa, pinfo))


def test_reference_dict_is_the_seeded_tree_through_jax(imported):
    """JAX's importer reads the synthetic dict back as the tree it was
    written from: the dict has the reference's layout."""
    for jp, src in zip(imported["jax_params"], imported["src"]):
        assert _equal_trees(jp, src)


def test_port_weights_equal_jax_import(imported):
    enc, dec = imported["port"]
    assert tuple(dec.q_prosody.vq_0.codebook.shape) == (16, 4)
    for jp, model in zip(imported["jax_params"], imported["port"]):
        assert _equal_trees(jp, model)


def test_imported_outputs(imported):
    jh, ja, jinfo = imported["jax_out"]
    ph, pa, pinfo = imported["port_out"]
    assert max_rel(ph, jh) <= MODULE_TOL
    assert np.array_equal(pinfo["codes"].numpy(), np.asarray(jinfo["codes"]))
    assert max_rel(pa, ja) <= PATH_TOL
    for k in ("f0", "phone", "prosody_phone", "content_f0", "res_f0",
              "res_phone", "x_timbre", "spk_embs"):
        assert max_rel(pinfo[k], jinfo[k]) <= PATH_TOL, k


def test_unplaced_key_raises(imported):
    sd_enc, sd_dec = imported["sd"]
    with pytest.raises(KeyError, match="block.9"):
        import_facodec_encoder({**sd_enc, "block.9.weight": torch.ones(1)},
                               P.FACodecEncoder(**SMALL_ENC))
    with pytest.raises(KeyError, match="spk_proj"):
        import_facodec_decoder({**sd_dec, "spk_proj.weight": torch.ones(1)},
                               P.FACodecDecoder(**SMALL_DEC, **GR_HEADS))
    missing = {k: v for k, v in sd_enc.items() if k != "block.0.bias"}
    with pytest.raises(KeyError, match="stem.bias"):
        import_facodec_encoder(missing, P.FACodecEncoder(**SMALL_ENC))
