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

Every branch of the JAX package's factory is here: the bottlenecks, the
oobleck / DAC / SEANet / local-attention / TAAE encoders and decoders
(an oobleck + VAE pair as the ``OobleckVAE``, any other pair through
``GenericAudioAutoencoder``), the autoencoder / DAC / wavelet / PQMF /
patched pretransforms, the 'dit' and adp U-Net ('adp_cfg_1d', 'adp_1d')
conditional models, the unconditional 'dit', 'DAU1d' and 'adp_uncond_1d',
the diffusion autoencoder and the token LM. 'audiocraft_pretrained' needs
the absent audiocraft package, as in the JAX package.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

import torch

from ditsep_tpu_torch.models import bottleneck as bn_mod
from ditsep_tpu_torch.models import codecs
from ditsep_tpu_torch.models import pretransforms as pt
from ditsep_tpu_torch.models.dau1d import DiffusionAttnUnet1D
from ditsep_tpu_torch.models.diffusion_ae import DiffusionAutoencoder
from ditsep_tpu_torch.models.dit import DiffusionTransformer
from ditsep_tpu_torch.models.lm import (
    AudioLM, DelayPattern, MusicLMPattern, ParallelPattern, UnrolledPattern,
)
from ditsep_tpu_torch.models.oobleck import (
    OobleckDecoder, OobleckEncoder, OobleckVAE,
)
from ditsep_tpu_torch.models.unet1d import create_unet_from_config


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


def _tuples(c: Dict[str, Any]) -> Dict[str, Any]:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in c.items()}


# the encodec options the SEANet here does not take: weight norm is its
# only norm, ELU its activation, its padding the symmetric scheme
_SEANET_DROPPED = ("norm", "activation", "activation_params", "causal",
                   "pad_mode", "final_activation")


def _seanet_config(c: Dict[str, Any]) -> Dict[str, Any]:
    c = {k: v for k, v in c.items() if k not in _SEANET_DROPPED}
    c["ratios"] = tuple(c.get("ratios", (8, 5, 4, 2)))
    return c


def create_encoder_from_config(enc_cfg: Dict[str, Any]):
    """The encoder dispatch (reference: autoencoders.py:782-824): 'oobleck',
    'dac', 'seanet' (its configured decoder-order ratios reversed inside,
    as the reference reverses them), 'local_attn', 'taae'. Unseeded:
    ``create_autoencoder_from_config`` seeds the whole."""
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
    if kind == "dac":
        return codecs.DACEncoderWrapper(
            d_model=c.get("d_model", 64),
            strides=tuple(c.get("strides", (2, 4, 8, 8))),
            latent_dim=c.get("latent_dim"),
            in_channels=c.get("in_channels", 1))
    if kind == "seanet":
        return codecs.SEANetEncoder(**_seanet_config(c))
    if kind == "local_attn":
        return codecs.LocalTransformerEncoder1D(**_tuples(c))
    if kind == "taae":
        return codecs.TAAEEncoder(**_tuples(c))
    raise NotImplementedError(f"Unknown encoder type: {kind}")


def create_decoder_from_config(dec_cfg: Dict[str, Any]):
    """The decoder dispatch (reference: autoencoders.py:826-864), as the
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
    if kind == "dac":
        return codecs.DACDecoderWrapper(
            latent_dim=c.get("latent_dim", 32),
            channels=c.get("channels", 1536),
            rates=tuple(c.get("rates", (8, 8, 4, 2))),
            out_channels=c.get("out_channels", 1))
    if kind == "seanet":
        return codecs.SEANetDecoder(**_seanet_config(c))
    if kind == "local_attn":
        return codecs.LocalTransformerDecoder1D(**_tuples(c))
    if kind == "taae":
        return codecs.TAAEDecoder(**_tuples(c))
    raise NotImplementedError(f"Unknown decoder type: {kind}")


def create_autoencoder_from_config(cfg: Dict[str, Any],
                                   generator: Optional[torch.Generator]
                                   = None):
    """An autoencoder from the reference JSON schema (reference:
    autoencoders.py:866-905), seeded: an oobleck encoder and decoder with
    a VAE bottleneck is the ``OobleckVAE`` (its decoder's latent width
    ``model.latent_dim``); any other combination a
    ``GenericAudioAutoencoder``."""
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
    return _seeded(codecs.GenericAudioAutoencoder(
        encoder=create_encoder_from_config(enc),
        decoder=create_decoder_from_config(dec),
        latent_dim=model.get("latent_dim", 64), bottleneck_type=bn["type"],
        bottleneck_config=bn.get("config"),
        soft_clip=model.get("soft_clip", False)), generator)


def create_pretransform_from_config(cfg: Dict[str, Any],
                                    sample_rate: Optional[int] = None,
                                    generator: Optional[torch.Generator]
                                    = None):
    """The pretransform dispatch (reference: factory.py:32-88): an
    'autoencoder' is built seeded (swap real weights in with
    ``load_params_npz(path, pre.model)``) and frozen; 'dac_pretrained' is
    the published descript codec's architecture ('44khz', '24khz' or
    '16khz'), seeded and frozen; 'wavelet', 'pqmf' and 'patched' hold no
    weights. 'audiocraft_pretrained' needs the absent audiocraft package and
    its weights, as in the JAX package."""
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
        # the published descript codecs' hyperparameters (the reference
        # reads them from the downloaded checkpoint)
        arch = {"44khz": ((2, 4, 8, 8), 9), "24khz": ((2, 4, 5, 8), 32),
                "16khz": ((2, 4, 5, 8), 12)}
        strides, n_codebooks = arch[c.get("model_type", "44khz")]
        latent_dim = 64 * 2 ** len(strides)
        g = generator or torch.Generator().manual_seed(0)
        parts = []
        for m in (codecs.DACEncoderWrapper(d_model=64, strides=strides),
                  codecs.DACDecoderWrapper(latent_dim=latent_dim,
                                           channels=1536,
                                           rates=tuple(reversed(strides))),
                  bn_mod.DACResidualVQ(input_dim=latent_dim,
                                       n_codebooks=n_codebooks,
                                       codebook_size=1024, codebook_dim=8)):
            parts.append(_seeded(m, g))
        return pt.DACPretransform(
            *parts, scale=c.get("scale", 1.0),
            quantize_on_decode=c.get("quantize_on_decode", True),
            enable_grad=cfg.get("enable_grad", False))
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
    """A conditional diffusion model and its routing from the reference
    diffusion_cond JSON schema: (the model, CondRouting, conditioner
    configs), plus the config's pretransform (or None) with
    ``include_pretransform``. The model is a DiffusionTransformer, its
    conditioning widths from the config (``cond_token_dim``,
    ``global_cond_dim``) as the JAX package reads them, or for 'adp_cfg_1d'
    / 'adp_1d' the adp U-Net in a ``UNetCondAdapter``; seeded. The DiT's
    input-concat and prepend widths (the inpaint and prior models'
    conditioning) come from the reference DiT's keys ``input_concat_dim``
    and ``prepend_cond_dim``, which flax infers at the first call."""
    from ditsep_tpu_torch.training.diffusion import CondRouting

    model = cfg["model"]
    diff = model["diffusion"]
    dit_cfg = diff.get("config", {})
    diff_type = diff.get("type", "dit")
    if diff_type in ("adp_cfg_1d", "adp_1d"):
        dit = _seeded(create_unet_from_config(diff_type, dit_cfg), generator)
    else:
        dit = _seeded(DiffusionTransformer(
            io_channels=diff.get("io_channels", model.get("io_channels", 64)),
            embed_dim=dit_cfg.get("embed_dim", 768),
            depth=dit_cfg.get("depth", 12),
            num_heads=dit_cfg.get("num_heads", 8),
            cond_token_dim=dit_cfg.get("cond_token_dim", 0),
            global_cond_dim=dit_cfg.get("global_cond_dim", 0),
            project_cond_tokens=dit_cfg.get("project_cond_tokens", True),
            input_concat_dim=dit_cfg.get("input_concat_dim", 0),
            prepend_cond_dim=dit_cfg.get("prepend_cond_dim", 0),
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


def create_diffAE_from_config(cfg: Dict[str, Any],
                              generator: Optional[torch.Generator] = None):
    """A ``DiffusionAutoencoder`` from the reference diffAE JSON schema
    (reference: autoencoders.py:911-974): an optional oobleck encoder to
    the latent and a diffusion net ('dit', 'adp_1d' or 'adp_cfg_1d')
    reconstructing the audio from it; seeded, the encoder first."""
    model = cfg["model"]
    latent_dim, io_channels = model["latent_dim"], model["io_channels"]
    g = generator or torch.Generator().manual_seed(0)
    encoder = None
    enc_cfg = model.get("encoder")
    if enc_cfg is not None:
        if enc_cfg["type"] != "oobleck":
            raise NotImplementedError(
                "only oobleck encoders are supported for "
                "diffusion_autoencoder")
        e = enc_cfg.get("config", {})
        encoder = _seeded(OobleckEncoder(
            in_channels=e.get("in_channels", io_channels),
            channels=e.get("channels", 128),
            latent_dim=e.get("latent_dim", latent_dim),
            c_mults=tuple(e.get("c_mults", (1, 2, 4, 8, 16))),
            strides=tuple(e.get("strides", (2, 4, 4, 8, 8))),
            use_snake=e.get("use_snake", False)), g)
    diff = model["diffusion"]
    diff_type, dc = diff.get("type", "dit"), diff.get("config", {})
    if diff_type in ("adp_1d", "adp_cfg_1d"):
        diffusion = create_unet_from_config(diff_type, dc)
    elif diff_type == "dit":
        diffusion = DiffusionTransformer(
            io_channels=dc.get("io_channels", io_channels),
            embed_dim=dc.get("embed_dim", 768), depth=dc.get("depth", 12),
            num_heads=dc.get("num_heads", 8),
            cond_token_dim=dc.get("cond_token_dim", 0),
            global_cond_dim=dc.get("global_cond_dim", 0))
    else:
        raise NotImplementedError(f"Unknown diffAE diffusion type: "
                                  f"{diff_type}")
    return DiffusionAutoencoder(
        encoder=encoder, diffusion=_seeded(diffusion, g),
        latent_dim=latent_dim,
        downsampling_ratio=model["downsampling_ratio"],
        io_channels=io_channels)


def create_audio_lm_from_config(cfg: Dict[str, Any],
                                generator: Optional[torch.Generator] = None):
    """(AudioLM, pattern) from the reference lm JSON schema (reference:
    lm.py:471-540), the LM seeded. ``n_quantizers`` / ``codebook_size`` come
    from ``model.lm.config`` or, as the reference derives them, from the
    discrete pretransform's bottleneck config; the backbone is the
    continuous transformer; the pattern 'delay' (default), 'parallel',
    'unroll' or 'musiclm'."""
    model = cfg["model"]
    lm_cfg = model.get("lm")
    if lm_cfg is None:
        raise ValueError("lm config must be specified in model config")
    c = dict(lm_cfg.get("config", {}))
    n_q = c.pop("n_quantizers", None)
    codebook_size = c.pop("codebook_size", None)
    pre = model.get("pretransform")
    if pre is not None:
        bc = pre.get("config", {}).get("bottleneck", {}).get("config", {})
        n_q = n_q or bc.get("num_quantizers", bc.get("n_codebooks"))
        codebook_size = codebook_size or bc.get("codebook_size")
    if not (n_q and codebook_size):
        raise ValueError("n_quantizers/codebook_size must come from "
                         "model.lm.config or a discrete pretransform "
                         "bottleneck config")
    lm_type = lm_cfg.get("type", "continuous_transformer")
    if lm_type != "continuous_transformer":
        raise NotImplementedError(
            f"Unrecognized lm type {lm_type} (continuous_transformer covers "
            "the shipped configs, as in the JAX package)")
    lm = _seeded(AudioLM(
        n_quantizers=int(n_q), codebook_size=int(codebook_size),
        dim=c.get("embed_dim", c.get("dim", 256)), depth=c.get("depth", 4),
        num_heads=c.get("num_heads", 4),
        cross_attn_cond_dim=c.get("cross_attn_cond_dim", 0),
        prepend_cond_dim=c.get("prepend_cond_dim", 0),
        global_cond_dim=c.get("global_cond_dim", 0),
        conformer=c.get("conformer", False)), generator)
    patterns = {"parallel": ParallelPattern, "delay": DelayPattern,
                "unroll": UnrolledPattern, "musiclm": MusicLMPattern}
    name = lm_cfg.get("codebook_pattern", "delay")
    if name not in patterns:
        raise NotImplementedError(f"Unknown codebook pattern: {name}")
    return lm, patterns[name](lm.n_quantizers, int(codebook_size))


def create_diffusion_uncond_from_config(cfg: Dict[str, Any],
                                        generator: Optional[torch.Generator]
                                        = None):
    """The unconditional dispatch (reference: models/diffusion.py:595-637):
    a config in the conditional schema (``model.diffusion``) gives its
    bare model; ``model.type`` 'DAU1d' (the dance-diffusion configs) a
    ``DiffusionAttnUnet1D``, 'adp_uncond_1d' the plain adp U-Net in its
    adapter, 'dit' a plain DiT; seeded."""
    model = cfg["model"]
    if "diffusion" in model:
        return create_diffusion_cond_from_config(cfg, generator=generator)[0]
    kind = model.get("type")
    c = dict(model.get("config", {}))
    if kind == "DAU1d":
        return _seeded(DiffusionAttnUnet1D(**_tuples(c)), generator)
    if kind == "adp_uncond_1d":
        return _seeded(create_unet_from_config("adp_1d", c), generator)
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
        return create_diffAE_from_config(cfg, generator)
    if model_type == "lm":
        return create_audio_lm_from_config(cfg, generator)
    raise NotImplementedError(f"Unknown model type: {model_type}")


def create_model_from_config_path(path: str,
                                  generator: Optional[torch.Generator]
                                  = None):
    with open(path) as f:
        return create_model_from_config(json.load(f), generator)
