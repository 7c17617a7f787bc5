"""Reference FACodec checkpoints -> the port's FACodec (port of
ditsep_tpu/models/facodec_import.py; reference: src/models/facodec/
facodec.py FACodecEncoder / FACodecDecoder, weight norm as ``weight_v`` /
``weight_g``).

The port keeps the reference's tensor layouts (a weight-normed conv's
``weight_v`` (out, in, k) and ``weight_g`` (out, 1, 1), a transposed
conv's per input channel, a weight-normed Linear's (out, in) and (out, 1),
torch MultiheadAttention's fused ``in_proj`` as the ``qkv_{i}`` Dense), so
an import is a rename from the reference's ``nn.Sequential`` keys to the
port's flax names and a strict, shape-checked copy. The reference's
deterministic buffers (the alias-free FIR taps ``*.upsample.filter`` /
``*.downsample.lowpass.filter`` and the timbre encoder's
``position_emb.pe``) are recomputed and skipped; any other key that finds
no place raises. The decoder's codebook size and width are taken from the
state dict, as the JAX package's importer takes them: quantizers of
another size are rebuilt to fit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch.nn as nn

from ditsep_tpu_torch.models.facodec import FACodecDecoder, FacodecRVQ
from ditsep_tpu_torch.models.weights import load_state

__all__ = ["import_facodec_encoder", "import_facodec_decoder",
           "facodec_encoder_key_map", "facodec_decoder_key_map"]

# the reference's buffers that the port recomputes from the config
_SKIPPED_SUFFIXES = (".upsample.filter", ".downsample.lowpass.filter",
                     "position_emb.pe")


def _wn(m: Dict[str, str], port: str, ref: str) -> None:
    """A weight-normed conv or Linear: ``weight_v``, ``weight_g``,
    ``bias``."""
    for leaf in ("weight_v", "weight_g", "bias"):
        m[f"{ref}.{leaf}"] = f"{port}.{leaf}"


def _plain(m: Dict[str, str], port: str, ref: str) -> None:
    """A Linear, Conv1d or LayerNorm: ``weight``, ``bias``."""
    for leaf in ("weight", "bias"):
        m[f"{ref}.{leaf}"] = f"{port}.{leaf}"


def _snake(m: Dict[str, str], port: str, ref: str) -> None:
    """Activation1d wraps SnakeBeta as ``.act`` (reference:
    alias_free_torch/act.py:20)."""
    for leaf in ("alpha", "beta"):
        m[f"{ref}.act.{leaf}"] = f"{port}.snake.{leaf}"


def _res_unit(m: Dict[str, str], port: str, ref: str) -> None:
    """ResidualUnit.block = [act, conv7, act, conv1] (reference:
    facodec.py:123-136)."""
    _snake(m, f"{port}.act_0", f"{ref}.block.0")
    _wn(m, f"{port}.conv_0", f"{ref}.block.1")
    _snake(m, f"{port}.act_1", f"{ref}.block.2")
    _wn(m, f"{port}.conv_1", f"{ref}.block.3")


def facodec_encoder_key_map(n_blocks: int) -> Dict[str, str]:
    """{reference key: the port's key} of an encoder with ``n_blocks``
    blocks (reference facodec.py:159-186): block.0 the stem; block.{1..n}
    EncoderBlock (.block = [res, res, res, act, down]); block.{n+1} the
    act; block.{n+2} the head."""
    m: Dict[str, str] = {}
    _wn(m, "stem", "block.0")
    for i in range(n_blocks):
        ref = f"block.{i + 1}.block"
        for j in range(3):
            _res_unit(m, f"block_{i}.res_{j}", f"{ref}.{j}")
        _snake(m, f"block_{i}.act", f"{ref}.3")
        _wn(m, f"block_{i}.down", f"{ref}.4")
    _snake(m, "act", f"block.{n_blocks + 1}")
    _wn(m, "head", f"block.{n_blocks + 2}")
    return m


def _rvq(m: Dict[str, str], port: str, ref: str, n: int) -> None:
    for j in range(n):
        _wn(m, f"{port}.vq_{j}.proj_in", f"{ref}.layers.{j}.in_proj")
        _wn(m, f"{port}.vq_{j}.proj_out", f"{ref}.layers.{j}.out_proj")
        m[f"{ref}.layers.{j}._codebook.weight"] = f"{port}.vq_{j}.codebook"


def _timbre_encoder(m: Dict[str, str], port: str, ref: str,
                    n_layers: int) -> None:
    """TransformerEncoder (reference transformer.py:154-234): torch
    MultiheadAttention's fused ``in_proj`` (q | k | v along dim 0) is the
    port's ``qkv_{i}``; the conv FFN's weight (filter, d, k) as it is."""
    for i in range(n_layers):
        lr = f"{ref}.layers.{i}"
        _plain(m, f"{port}.ln1_{i}", f"{lr}.ln_1")
        m[f"{lr}.self_attn.in_proj_weight"] = f"{port}.qkv_{i}.weight"
        m[f"{lr}.self_attn.in_proj_bias"] = f"{port}.qkv_{i}.bias"
        _plain(m, f"{port}.out_{i}", f"{lr}.self_attn.out_proj")
        _plain(m, f"{port}.ln2_{i}", f"{lr}.ln_2")
        _plain(m, f"{port}.ffn1_{i}", f"{lr}.ffn.ffn_1")
        _plain(m, f"{port}.ffn2_{i}", f"{lr}.ffn.ffn_2")
    _plain(m, f"{port}.ln_out", f"{ref}.last_ln")


def _cnnlstm_head(m: Dict[str, str], port: str, ref: str,
                  n_heads: int) -> None:
    """CNNLSTM (reference facodec.py:37-57): model = [res x 3, act,
    rearrange]; heads.{i} Linear."""
    for i in range(3):
        _res_unit(m, f"{port}.res_{i}", f"{ref}.model.{i}")
    _snake(m, f"{port}.act", f"{ref}.model.3")
    for i in range(n_heads):
        _plain(m, f"{port}.head_{i}", f"{ref}.heads.{i}")


def facodec_decoder_key_map(model: FACodecDecoder) -> Dict[str, str]:
    """{reference key: the port's key} of ``model``'s config (reference
    facodec.py:244-412): quantizer.{0,1,2} the groups; model.0 the stem;
    model.{1..n} DecoderBlock (.block = [act, up, res, res, res]);
    model.{n+1} the act; model.{n+2} the head; timbre_encoder /
    timbre_linear; the predictors, a gradient-reversal one as
    nn.Sequential(GR, CNNLSTM), its CNNLSTM at index 1."""
    m: Dict[str, str] = {}
    _rvq(m, "q_prosody", "quantizer.0", model.vq_num_q_p)
    _rvq(m, "q_content", "quantizer.1", model.vq_num_q_c)
    if model.vq_num_q_r > 0:
        _rvq(m, "q_residual", "quantizer.2", model.vq_num_q_r)
    _timbre_encoder(m, "timbre_encoder", "timbre_encoder",
                    model.timbre_layers)
    _plain(m, "timbre_film", "timbre_linear")
    _cnnlstm_head(m, "f0_head", "f0_predictor", 2)
    _cnnlstm_head(m, "phone_head", "phone_predictor", 1)
    n_up = len(model.up_ratios)
    _wn(m, "dec_stem", "model.0")
    for i in range(n_up):
        ref = f"model.{i + 1}.block"
        _snake(m, f"dec_block_{i}.act", f"{ref}.0")
        _wn(m, f"dec_block_{i}.up", f"{ref}.1")
        for j in range(3):
            _res_unit(m, f"dec_block_{i}.res_{j}", f"{ref}.{2 + j}")
    _snake(m, "dec_act", f"model.{n_up + 1}")
    _wn(m, "dec_head", f"model.{n_up + 2}")
    heads = (("prosody_phone_head", "prosody_phone_predictor", 1,
              model.use_gr_prosody_phone),
             ("content_f0_head", "content_f0_predictor", 2,
              model.use_gr_content_f0),
             ("res_f0_head", "res_f0_predictor", 2,
              model.vq_num_q_r > 0 and model.use_gr_residual_f0),
             ("res_phone_head", "res_phone_predictor", 1,
              model.vq_num_q_r > 0 and model.use_gr_residual_phone),
             ("x_timbre_head", "x_timbre_predictor", 1,
              model.use_gr_x_timbre))
    for port, ref, n, on in heads:
        if on:
            _cnnlstm_head(m, port, f"{ref}.1", n)
    return m


def _load(model: nn.Module, state_dict: Mapping[str, Any],
          key_map: Dict[str, str], what: str) -> nn.Module:
    unplaced = [k for k in state_dict if k not in key_map
                and not k.endswith(_SKIPPED_SUFFIXES)]
    if unplaced:
        raise KeyError(f"{what} state dict: no place for {unplaced}")
    state = {port: state_dict[ref] for ref, port in key_map.items()
             if ref in state_dict}
    return load_state(model, state, source=f"the {what} state dict")


def import_facodec_encoder(state_dict: Mapping[str, Any],
                           model: nn.Module) -> nn.Module:
    """Load a reference FACodecEncoder state_dict into ``model``, a
    ``FACodecEncoder`` of the same config, strictly; returns it."""
    return _load(model, state_dict,
                 facodec_encoder_key_map(len(model.up_ratios)), "encoder")


def _fit_codebooks(model: FACodecDecoder,
                   state_dict: Mapping[str, Any]) -> None:
    """Rebuild the quantizer groups at the state dict's codebook size and
    width where they differ from ``model``'s."""
    size, dim = tuple(state_dict["quantizer.0.layers.0._codebook.weight"]
                      .shape)
    cb = model.q_prosody.vq_0.codebook
    if tuple(cb.shape) == (size, dim):
        return
    for name, n in (("q_prosody", model.vq_num_q_p),
                    ("q_content", model.vq_num_q_c),
                    ("q_residual", model.vq_num_q_r)):
        if n > 0:
            setattr(model, name, FacodecRVQ(n, model.in_channels, size, dim)
                    .to(device=cb.device, dtype=cb.dtype))


def import_facodec_decoder(state_dict: Mapping[str, Any],
                           model: FACodecDecoder) -> FACodecDecoder:
    """Load a reference FACodecDecoder state_dict into ``model`` (its
    config gives the up ratios, the quantizer counts and the GR heads; the
    codebooks' size and width come from the state dict), strictly;
    returns it."""
    _fit_codebooks(model, state_dict)
    return _load(model, state_dict, facodec_decoder_key_map(model),
                 "decoder")
