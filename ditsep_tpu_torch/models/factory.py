"""The stable-audio JSON model-config factory (port of
ditsep_tpu/models/factory.py; reference: stable-audio-tools
models/factory.py:3-161, autoencoders.py:782-905).

It reads the reference JSON schema and builds the port's modules with
seeded weights (``torch.Generator().manual_seed(0)`` unless a generator is
given) on the default device: the CPU, or the card inside ``with
torch.device("cuda")`` with a cuda generator. Move them with
``.to(device)``, and load real weights with
``models.weights.load_params_npz`` or the ``models.torch_import``
importers.

Ported: every bottleneck, the oobleck encoder and decoder, the
oobleck + VAE autoencoder, the autoencoder / wavelet / PQMF / patched
pretransforms, the 'dit' conditional and unconditional diffusion models
with their conditioning routing. The DAC / SEANet / local-attention / TAAE
codecs (with the generic autoencoder and the DAC pretransform), the
audio-diffusion U-Nets ('adp_*', 'DAU1d'), the diffusion autoencoder and
the token LM raise naming ROADMAP A16.3b.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch

from ditsep_tpu_torch.models import bottleneck as bn_mod
from ditsep_tpu_torch.models import pretransforms as pt
from ditsep_tpu_torch.models.dit import DiffusionTransformer
from ditsep_tpu_torch.models.oobleck import (
    OobleckDecoder, OobleckEncoder, OobleckVAE,
)


def _a16_3b(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A16.3b: models/{{codecs,unet1d,"
        f"dau1d,diffusion_ae,lm}}.py)")


def _seeded(module, generator: Optional[torch.Generator]):
    """``module`` with its parameters drawn from ``generator`` (seed 0 by
    default), in module order."""
    module.reset_parameters(generator or torch.Generator().manual_seed(0))
    return module


def create_bottleneck_from_config(cfg: Dict[str, Any]):
    """(reference: factory.py create_bottleneck_from_config)."""
    kind = cfg["type"]
    c = cfg.get("config", {})
    if kind == "vae":
        return bn_mod.VAEBottleneck()
    if kind == "tanh":
        return bn_mod.TanhBottleneck(**c)
    if kind == "wasserstein":
        return bn_mod.WassersteinBottleneck(**c)
    if kind == "l2_norm":
        return bn_mod.L2Bottleneck()
    if kind in ("rvq", "rvq_vae"):
        default_dim, default_q = (64, 4) if kind == "rvq" else (128, 8)
        q = bn_mod.ResidualVQ(
            dim=c.get("dim", default_dim),
            codebook_size=c.get("codebook_size", 1024),
            num_quantizers=c.get("num_quantizers", default_q))
        return (bn_mod.RVQBottleneck(q) if kind == "rvq"
                else bn_mod.RVQVAEBottleneck(q))
    if kind == "fsq":
        return bn_mod.FSQBottleneck(levels=tuple(c.get("levels",
                                                       (8, 5, 5, 5))))
    if kind == "dithered_fsq":
        return bn_mod.DitheredFSQBottleneck.build(
            dim=c["dim"], levels=c["levels"],
            num_codebooks=c.get("num_codebooks", 1),
            dither_inference=c.get("dither_inference", True),
            noise_dropout=c.get("noise_dropout", 0.05))
    if kind in ("dac_rvq", "dac_rvq_vae"):
        q = bn_mod.DACResidualVQ(
            input_dim=c.get("input_dim", c.get("dim", 64)),
            n_codebooks=c.get("n_codebooks", 9),
            codebook_size=c.get("codebook_size", 1024),
            codebook_dim=c.get("codebook_dim", 8))
        if kind == "dac_rvq":
            return bn_mod.DACRVQBottleneck(
                q, quantize_on_decode=c.get("quantize_on_decode", False),
                noise_augment_dim=c.get("noise_augment_dim", 0))
        return bn_mod.DACRVQVAEBottleneck(
            q, quantize_on_decode=c.get("quantize_on_decode", False))
    raise NotImplementedError(f"Unknown bottleneck type: {kind}")


def create_encoder_from_config(enc_cfg: Dict[str, Any]):
    """The encoder dispatch (reference: autoencoders.py:782-824): 'oobleck'
    is ported; 'dac', 'seanet', 'local_attn' and 'taae' raise."""
    kind = enc_cfg["type"]
    c = dict(enc_cfg.get("config", {}))
    if kind == "oobleck":
        return OobleckEncoder(
            in_channels=c.get("in_channels", 1),
            channels=c.get("channels", 128),
            latent_dim=c.get("latent_dim", 32),
            c_mults=tuple(c.get("c_mults", (1, 2, 4, 8, 16))),
            strides=tuple(c.get("strides", (2, 4, 4, 8, 8))),
            use_snake=c.get("use_snake", False))
    if kind in ("dac", "seanet", "local_attn", "taae"):
        raise _a16_3b(f"The {kind!r} encoder")
    raise NotImplementedError(f"Unknown encoder type: {kind}")


def create_decoder_from_config(dec_cfg: Dict[str, Any]):
    """The decoder dispatch (reference: autoencoders.py:826-864): as the
    encoder's."""
    kind = dec_cfg["type"]
    c = dict(dec_cfg.get("config", {}))
    if kind == "oobleck":
        return OobleckDecoder(
            out_channels=c.get("out_channels", 1),
            channels=c.get("channels", 128),
            latent_dim=c.get("latent_dim", 32),
            c_mults=tuple(c.get("c_mults", (1, 2, 4, 8, 16))),
            strides=tuple(c.get("strides", (2, 4, 4, 8, 8))),
            use_snake=c.get("use_snake", False),
            use_nearest_upsample=c.get("use_nearest_upsample", False))
    if kind in ("dac", "seanet", "local_attn", "taae"):
        raise _a16_3b(f"The {kind!r} decoder")
    raise NotImplementedError(f"Unknown decoder type: {kind}")


def create_autoencoder_from_config(cfg: Dict[str, Any],
                                   generator: Optional[torch.Generator]
                                   = None):
    """An autoencoder from the reference JSON schema (reference:
    autoencoders.py:866-905): an oobleck encoder and decoder with a VAE
    bottleneck is the ``OobleckVAE`` (its decoder's latent width
    ``model.latent_dim``), seeded. Any other combination composes through
    the JAX package's ``GenericAudioAutoencoder`` (models/codecs.py), not
    ported yet."""
    model = cfg["model"]
    enc, dec = model["encoder"], model["decoder"]
    bn = model.get("bottleneck", {"type": "vae"}) or {"type": "none"}
    if (enc["type"] == "oobleck" and dec["type"] == "oobleck"
            and bn["type"] == "vae"):
        e, d = enc["config"], dec["config"]
        return _seeded(OobleckVAE(
            in_channels=e.get("in_channels", 1),
            out_channels=d.get("out_channels", 1),
            channels=e.get("channels", 128),
            latent_dim=model.get("latent_dim", d.get("latent_dim", 64)),
            c_mults=tuple(e.get("c_mults", (1, 2, 4, 8, 16))),
            strides=tuple(e.get("strides", (2, 4, 4, 8, 8))),
            use_snake=e.get("use_snake", False)), generator)
    raise _a16_3b(f"An autoencoder of {enc['type']!r} / {dec['type']!r} / "
                  f"{bn['type']!r} (GenericAudioAutoencoder)")


def create_pretransform_from_config(cfg: Dict[str, Any],
                                    sample_rate: Optional[int] = None,
                                    generator: Optional[torch.Generator]
                                    = None):
    """The pretransform dispatch (reference: factory.py:32-88): an
    'autoencoder' is built seeded (swap real weights in with
    ``load_params_npz(path, pre.model)``) and frozen; 'wavelet', 'pqmf' and
    'patched' hold no weights. 'dac_pretrained' raises (A16.3b);
    'audiocraft_pretrained' needs the absent audiocraft package and its
    weights, as in the JAX package."""
    kind = cfg["type"]
    c = dict(cfg.get("config", {}))
    if kind == "autoencoder":
        model = create_autoencoder_from_config(
            {"sample_rate": sample_rate, "model": c}, generator)
        return pt.AutoencoderPretransform(
            model, scale=cfg.get("scale", 1.0),
            chunked=cfg.get("chunked", False))
    if kind == "wavelet":
        return pt.WaveletPretransform(channels=c["channels"],
                                      levels=c["levels"])
    if kind == "pqmf":
        return pt.PQMFPretransform(**c)
    if kind == "patched":
        return pt.PatchedPretransform(**c)
    if kind == "dac_pretrained":
        raise _a16_3b("The 'dac_pretrained' pretransform")
    if kind == "audiocraft_pretrained":
        raise NotImplementedError(
            "audiocraft_pretrained needs the audiocraft package and its "
            "pretrained EnCodec weights, absent here; the reference's "
            "continuous encode / decode refuse this type too (reference: "
            "pretransforms.py:211-275)")
    raise NotImplementedError(f"Unknown pretransform type: {kind}")


def create_diffusion_cond_from_config(cfg: Dict[str, Any],
                                      include_pretransform: bool = False,
                                      generator: Optional[torch.Generator]
                                      = None):
    """A conditional DiT and its routing from the reference diffusion_cond
    JSON schema: (DiffusionTransformer, CondRouting, conditioner configs),
    plus the config's pretransform (or None) with
    ``include_pretransform``. The DiT's conditioning widths come from the
    config (``cond_token_dim``, ``global_cond_dim``), as the JAX package
    reads them; its weights are seeded."""
    from ditsep_tpu_torch.training.diffusion import CondRouting

    model = cfg["model"]
    diff = model["diffusion"]
    dit_cfg = diff.get("config", {})
    diff_type = diff.get("type", "dit")
    if diff_type in ("adp_cfg_1d", "adp_1d"):
        raise _a16_3b(f"The {diff_type!r} U-Net (models/unet1d.py)")
    dit = _seeded(DiffusionTransformer(
        io_channels=diff.get("io_channels", model.get("io_channels", 64)),
        embed_dim=dit_cfg.get("embed_dim", 768),
        depth=dit_cfg.get("depth", 12),
        num_heads=dit_cfg.get("num_heads", 8),
        cond_token_dim=dit_cfg.get("cond_token_dim", 0),
        global_cond_dim=dit_cfg.get("global_cond_dim", 0),
        project_cond_tokens=dit_cfg.get("project_cond_tokens", True),
        diffusion_objective=diff.get("diffusion_objective", "v")),
        generator)
    routing = CondRouting(
        cross_attn_cond_ids=tuple(diff.get("cross_attention_cond_ids", ())),
        global_cond_ids=tuple(diff.get("global_cond_ids", ())),
        input_concat_ids=tuple(diff.get("input_concat_ids", ())),
        prepend_cond_ids=tuple(diff.get("prepend_cond_ids", ())))
    cond_cfgs = model.get("conditioning", {}).get("configs", [])
    if include_pretransform:
        pre_cfg = model.get("pretransform")
        pre = (None if pre_cfg is None else create_pretransform_from_config(
            pre_cfg, sample_rate=cfg.get("sample_rate"),
            generator=generator))
        return dit, routing, cond_cfgs, pre
    return dit, routing, cond_cfgs


def create_diffAE_from_config(cfg: Dict[str, Any]):
    raise _a16_3b("The diffusion autoencoder (models/diffusion_ae.py)")


def create_audio_lm_from_config(cfg: Dict[str, Any]):
    raise _a16_3b("The token LM (models/lm.py)")


def create_diffusion_uncond_from_config(cfg: Dict[str, Any],
                                        generator: Optional[torch.Generator]
                                        = None):
    """The unconditional dispatch (reference: models/diffusion.py:595-637):
    a config in the conditional schema (``model.diffusion``) gives its
    bare DiT; ``model.type`` 'dit' a plain DiT. 'DAU1d' and
    'adp_uncond_1d' raise (A16.3b)."""
    model = cfg["model"]
    if "diffusion" in model:
        return create_diffusion_cond_from_config(cfg, generator=generator)[0]
    kind = model.get("type")
    c = dict(model.get("config", {}))
    if kind in ("DAU1d", "adp_uncond_1d"):
        raise _a16_3b(f"The {kind!r} diffusion model")
    if kind == "dit":
        return _seeded(DiffusionTransformer(
            io_channels=c.get("io_channels", model.get("io_channels", 2)),
            embed_dim=c.get("embed_dim", 768), depth=c.get("depth", 12),
            num_heads=c.get("num_heads", 8)), generator)
    raise NotImplementedError(f"Unknown diffusion uncond type: {kind}")


def create_model_from_config(cfg: Dict[str, Any],
                             generator: Optional[torch.Generator] = None):
    """The top-level dispatch (reference: factory.py:3-24)."""
    model_type = cfg.get("model_type")
    if model_type is None:
        raise ValueError("model_type must be specified")
    if model_type == "autoencoder":
        return create_autoencoder_from_config(cfg, generator)
    if model_type in ("diffusion_cond", "diffusion_cond_inpaint",
                      "diffusion_prior"):
        return create_diffusion_cond_from_config(cfg, generator=generator)
    if model_type == "diffusion_uncond":
        return create_diffusion_uncond_from_config(cfg, generator)
    if model_type == "diffusion_autoencoder":
        return create_diffAE_from_config(cfg)
    if model_type == "lm":
        return create_audio_lm_from_config(cfg)
    raise NotImplementedError(f"Unknown model type: {model_type}")


def create_model_from_config_path(path: str,
                                  generator: Optional[torch.Generator]
                                  = None):
    with open(path) as f:
        return create_model_from_config(json.load(f), generator)
