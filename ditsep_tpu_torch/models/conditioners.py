"""Conditioning encoders for conditional diffusion (port of
ditsep_tpu/models/conditioners.py; reference: stable-audio-tools
models/conditioners.py:19-726).

A conditioner maps its input to ``(embedding (B, S, D), mask (B, S))``.
Heavy pretrained encoders (T5, CLAP) run on the host through the optional
``transformers`` package (``t5_encode_host`` / ``clap_encode_host``, the
encoder injectable); the module is the learned projection over their
output (``HostEmbeddingConditioner``). Submodules carry the JAX package's
flax names (``embedder.to_out``, ``int_embedder``, ``lut``, ``proj``,
``phoneme_embedder``, ``proj_out``), so ``models.weights.params_from_jax``
loads its parameters (an ``Embed``'s ``embedding`` is an
``nn.Embedding``'s ``weight``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ditsep_tpu_torch.models.transformer import Dense

Tensor = torch.Tensor


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _as_tensor(value, dtype: torch.dtype, device) -> Tensor:
    if isinstance(value, Tensor):
        return value.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


class _Embed(nn.Embedding):
    """flax's ``Embed``: a (num, dim) table initialised N(0, 1 / dim)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.weight.normal_(0.0, self.embedding_dim ** -0.5,
                                generator=generator)


class TimePositionalEmbedding(nn.Module):
    """Sinusoidal embedding of a scalar (``dim`` features) and a dense
    ``to_out`` projection."""

    def __init__(self, dim: int = 256, out_features: int = 768):
        super().__init__()
        self.dim = dim
        self.to_out = Dense(dim, out_features)

    def forward(self, x: Tensor) -> Tensor:
        half = self.dim // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(
            half, dtype=torch.float32, device=x.device) / half)
        ang = x[..., None] * freqs
        return self.to_out(torch.cat([ang.sin(), ang.cos()], dim=-1))


class NumberConditioner(nn.Module):
    """A scalar a row: clamp to [min_val, max_val], normalise to [0, 1],
    embed. Used for seconds_start / seconds_total."""

    def __init__(self, output_dim: int, min_val: float = 0.0,
                 max_val: float = 1.0):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val
        self.embedder = TimePositionalEmbedding(256, output_dim)

    def forward(self, floats, mask=None):
        x = _as_tensor(floats, torch.float32, _device(self))
        x = x.clamp(self.min_val, self.max_val)
        x = (x - self.min_val) / (self.max_val - self.min_val)
        emb = self.embedder(x)[:, None, :]  # (B, 1, D)
        return emb, torch.ones(emb.shape[:2], dtype=torch.bool,
                               device=emb.device)


class IntConditioner(nn.Module):
    """An integer a row, clamped, through a lookup table."""

    def __init__(self, output_dim: int, min_val: int = 0,
                 max_val: int = 512):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val
        self.int_embedder = _Embed(max_val - min_val + 1, output_dim)

    def forward(self, ints, mask=None):
        idx = _as_tensor(ints, torch.int64, _device(self))
        idx = idx.clamp(self.min_val, self.max_val) - self.min_val
        emb = self.int_embedder(idx)[:, None, :]
        return emb, torch.ones(emb.shape[:2], dtype=torch.bool,
                               device=emb.device)


class ListConditioner(nn.Module):
    """An index into ``options`` a row (the string lookup is the
    host's), through a lookup table."""

    def __init__(self, output_dim: int, options: Sequence[str] = ()):
        super().__init__()
        self.options = tuple(options)
        self.lut = _Embed(len(self.options), output_dim)

    def forward(self, indices, mask=None):
        emb = self.lut(_as_tensor(indices, torch.int64,
                                  _device(self)))[:, None, :]
        return emb, torch.ones(emb.shape[:2], dtype=torch.bool,
                               device=emb.device)


class PretransformConditioner(nn.Module):
    """Pretransform latents (B, D, T) -> a dense projection per frame,
    ((B, T, output_dim), all valid)."""

    def __init__(self, output_dim: int, latent_dim: int):
        super().__init__()
        self.proj = Dense(latent_dim, output_dim)

    def forward(self, latents, mask=None):
        emb = self.proj(_as_tensor(latents, torch.float32,
                                   _device(self)).transpose(1, 2))
        return emb, torch.ones(emb.shape[:2], dtype=torch.bool,
                               device=emb.device)


# ARPABET phoneme inventory (CMUdict): 39 phonemes, vowels with 0/1/2
# stress markers, the symbol set g2p_en exposes
_ARPABET_BASE = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG",
    "OW", "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W",
    "Y", "Z", "ZH"]
_VOWELS = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
           "IY", "OW", "OY", "UH", "UW"}
ARPABET_PHONEMES = ["_"] + [
    p + s for p in _ARPABET_BASE
    for s in (("0", "1", "2") if p in _VOWELS else ("",))]
_P2IDX = {p: i for i, p in enumerate(ARPABET_PHONEMES)}

# the rule-based English grapheme -> phoneme fallback, used where the
# g2p_en package is absent
_G2P_RULES = [
    ("tion", ["SH", "AH0", "N"]), ("ough", ["AO1"]), ("ch", ["CH"]),
    ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]), ("wh", ["W"]),
    ("ng", ["NG"]), ("qu", ["K", "W"]), ("ck", ["K"]), ("ee", ["IY1"]),
    ("oo", ["UW1"]), ("ou", ["AW1"]), ("ai", ["EY1"]), ("ay", ["EY1"]),
    ("oi", ["OY1"]), ("ea", ["IY1"]),
    ("a", ["AE1"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("e", ["EH1"]), ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]),
    ("i", ["IH1"]), ("j", ["JH"]), ("k", ["K"]), ("l", ["L"]),
    ("m", ["M"]), ("n", ["N"]), ("o", ["AA1"]), ("p", ["P"]),
    ("r", ["R"]), ("s", ["S"]), ("t", ["T"]), ("u", ["AH1"]),
    ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]), ("y", ["Y"]),
    ("z", ["Z"])]

_G2P_SINGLETON = None


def text_to_phonemes(text: str) -> List[str]:
    """English text -> ARPABET phonemes: g2p_en where installed, else the
    rule-based fallback; spaces and punctuation become '_'."""
    try:
        from g2p_en import G2p
        import string as _string
        global _G2P_SINGLETON
        ignore = set(" " + _string.punctuation)
        if _G2P_SINGLETON is None:
            _G2P_SINGLETON = G2p()  # loads its weights: keep one
        return ["_" if p in ignore else p for p in _G2P_SINGLETON(text)]
    except ImportError:
        pass
    out: List[str] = []
    for word in text.lower().split():
        i = 0
        w = "".join(ch for ch in word if ch.isalpha())
        while i < len(w):
            for pat, phones in _G2P_RULES:
                if w.startswith(pat, i):
                    out.extend(phones)
                    i += len(pat)
                    break
            else:
                i += 1
        out.append("_")
    return out[:-1] if out else []


def phonemes_to_ids(phonemes: List[str], max_length: int = 1024
                    ) -> List[int]:
    """Phoneme symbols -> table ids: 0 padding, 1 unknown, 2+ the
    inventory; cut to ``max_length``."""
    return [(_P2IDX[p] + 2 if p in _P2IDX else 1)
            for p in phonemes][:max_length]


class PhonemeConditioner(nn.Module):
    """A (B, S) grid of phoneme ids (0 padding) through a lookup table,
    optionally projected; the mask is ids != 0."""

    def __init__(self, output_dim: int, max_length: int = 1024,
                 project_out: bool = False):
        super().__init__()
        self.max_length = max_length
        self.phoneme_embedder = _Embed(len(ARPABET_PHONEMES) + 2, output_dim)
        if project_out:
            self.proj_out = Dense(output_dim, output_dim)

    def forward(self, phoneme_ids, mask=None):
        ids = _as_tensor(phoneme_ids, torch.int64, _device(self))
        emb = self.phoneme_embedder(ids)
        if hasattr(self, "proj_out"):
            emb = self.proj_out(emb)
        return emb, ids != 0


def clap_encode_host(texts=None, audio=None,
                     model_name: str = "laion/larger_clap_general",
                     model=None, processor=None):
    """CLAP text or audio embeddings on the host through the optional
    ``transformers`` package: numpy ((B, 1, D), all-True mask). ``model``
    / ``processor`` inject built objects (a local or random-weight
    ``ClapModel``); by default both come from ``from_pretrained``."""
    from transformers import AutoProcessor, ClapModel

    model = (model if model is not None
             else ClapModel.from_pretrained(model_name)).eval()
    proc = (processor if processor is not None
            else AutoProcessor.from_pretrained(model_name))
    with torch.no_grad():
        if texts is not None:
            inputs = proc(text=texts, return_tensors="pt", padding=True)
            emb = model.get_text_features(**inputs)
        else:
            inputs = proc(audios=list(audio), sampling_rate=48000,
                          return_tensors="pt")
            emb = model.get_audio_features(**inputs)
    emb = emb[:, None, :].numpy()
    return emb, np.ones(emb.shape[:2], bool)


def t5_encode_host(texts: List[str], model_name: str = "t5-base",
                   max_length: int = 128, tokenizer=None, encoder=None):
    """T5 text encoding on the host through the optional ``transformers``
    package: numpy (embeddings (B, max_length, D), attention mask), padded
    to ``max_length``. ``tokenizer`` / ``encoder`` inject built objects
    with the HF call contract; by default both come from
    ``from_pretrained``."""
    from transformers import AutoTokenizer, T5EncoderModel

    tok = (tokenizer if tokenizer is not None
           else AutoTokenizer.from_pretrained(model_name))
    enc = (encoder if encoder is not None
           else T5EncoderModel.from_pretrained(model_name)).eval()
    batch = tok(texts, truncation=True, max_length=max_length,
                padding="max_length", return_tensors="pt")
    with torch.no_grad():
        out = enc(input_ids=batch["input_ids"],
                  attention_mask=batch["attention_mask"])
    return (out.last_hidden_state.numpy(),
            batch["attention_mask"].numpy().astype(bool))


class HostEmbeddingConditioner(nn.Module):
    """The learned projection over a host encoder's embeddings (B, S,
    D_enc) ((B, D) for pooled CLAP, taken as S = 1). The mask is the
    encoder's when given (T5 emits non-zero states at padding), else the
    rows that are not all zero."""

    def __init__(self, output_dim: int, project_out: bool = True,
                 input_dim: Optional[int] = None):
        super().__init__()
        self.output_dim = output_dim
        input_dim = output_dim if input_dim is None else input_dim
        if project_out or input_dim != output_dim:
            self.proj_out = Dense(input_dim, output_dim)

    def forward(self, embeddings, mask=None):
        dev = (_device(self) if hasattr(self, "proj_out")
               else (embeddings.device if isinstance(embeddings, Tensor)
                     else torch.device("cpu")))
        raw = _as_tensor(embeddings, torch.float32, dev)
        emb = raw[:, None, :] if raw.ndim == 2 else raw
        if hasattr(self, "proj_out"):
            emb = self.proj_out(emb)
        if mask is not None:
            return emb, _as_tensor(mask, torch.bool, emb.device)
        hmask = ((raw != 0).any(dim=-1) if raw.ndim == 3
                 else torch.ones(emb.shape[:2], dtype=torch.bool,
                                 device=emb.device))
        return emb, hmask


def create_multi_conditioner_from_config(cond_config: Dict
                                         ) -> "MultiConditioner":
    """A MultiConditioner from the reference conditioning JSON schema: a
    ``configs`` list of {id, type, config} with a shared ``cond_dim``
    default width. The port builds its modules at construction, so a
    host-embedding conditioner takes its encoder's width from
    ``config.input_dim`` (``cond_dim`` when absent: t5-base's 768 in
    Stable Audio Open) and a pretransform conditioner from
    ``config.latent_dim``."""
    cond_dim = cond_config.get("cond_dim", 768)
    conditioners: Dict[str, nn.Module] = {}
    for cfg in cond_config.get("configs", []):
        cid, kind = cfg["id"], cfg["type"]
        c = dict(cfg.get("config", {}))
        out_dim = c.pop("output_dim", cond_dim)
        if kind == "number":
            conditioners[cid] = NumberConditioner(
                out_dim, min_val=c.get("min_val", 0.0),
                max_val=c.get("max_val", 1.0))
        elif kind == "int":
            conditioners[cid] = IntConditioner(
                out_dim, min_val=c.get("min_val", 0),
                max_val=c.get("max_val", 512))
        elif kind == "list":
            conditioners[cid] = ListConditioner(
                out_dim, options=tuple(c.get("options", ())))
        elif kind == "phoneme":
            conditioners[cid] = PhonemeConditioner(
                out_dim, max_length=c.get("max_length", 1024),
                project_out=c.get("project_out", False))
        elif kind in ("t5", "clap_text", "clap_audio"):
            conditioners[cid] = HostEmbeddingConditioner(
                out_dim, project_out=c.get("project_out", True),
                input_dim=c.get("input_dim", cond_dim))
        elif kind == "pretransform":
            conditioners[cid] = PretransformConditioner(
                out_dim, c.get("latent_dim", cond_dim))
        else:
            raise ValueError(f"unknown conditioner type {kind!r}")
    return MultiConditioner(conditioners,
                            cond_config.get("default_keys", {}))


class MultiConditioner(nn.ModuleDict):
    """Route a metadata dict through named conditioners: ``cond(inputs)``
    -> {name: (embedding, mask)}. An input is found under the
    conditioner's name or its ``default_keys`` entry; an (embeddings,
    mask) pair (what ``t5_encode_host`` returns) passes the mask on."""

    def __init__(self, conditioners: Dict[str, nn.Module],
                 default_keys: Optional[Dict[str, str]] = None):
        super().__init__(conditioners)
        self.default_keys = dict(default_keys or {})

    def forward(self, batch_inputs: Dict) -> Dict:
        out = {}
        for name, cond in self.items():
            src = name if name in batch_inputs else self.default_keys[name]
            val = batch_inputs[src]
            if isinstance(val, tuple) and len(val) == 2:
                out[name] = cond(val[0], mask=val[1])
            else:
                out[name] = cond(val)
        return out
