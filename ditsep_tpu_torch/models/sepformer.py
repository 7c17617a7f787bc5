"""SepFormer: dual-path transformer masking separation (port of
ditsep_tpu/models/sepformer.py; Subakan et al. 2021, "Attention is All You
Need in Speech Separation"):

  waveform -> Conv1d(kernel 16, stride 8) encoder -> dual-path masknet
  (50% overlap chunks; intra-chunk and inter-chunk pre-LN transformer
  stacks) -> one multiplicative mask a source -> ConvTranspose1d decoder.

The module tree and its state_dict are SpeechBrain's ``sepformer-wsj02mix``
layout (``encoder.conv1d.weight``, ``masknet.dual_mdl.{i}.{intra,inter}_
mdl.mdl.layers.{j}.{self_att.att,pos_ffn.ffn.{0,3},norm{1,2}.norm}.*``,
``decoder.weight``), so a SpeechBrain checkpoint loads through
``sepformer_params_from_torch`` (a key check, then ``load_state_dict``),
and ``models.weights.params_from_jax`` maps the JAX package's flax tree
onto it (``SepFormer.params_from_jax``). The activations follow
SpeechBrain's channel-first layout: (B, N, L) features, (B, N, K, S)
chunks.

Everything is stock PyTorch (cuDNN convs, cuBLAS, SDPA), as the JAX
package computes the model outside any Pallas kernel. The decoder is
``F.conv_transpose1d``, where the JAX package lowers it as a matmul plus
``ops.stft.overlap_add``; the output is cut or zero-padded to the input's
length T as there. It computes in float32 (the JAX module's ``dtype``
field, which no caller sets, is not ported).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Tensor = torch.Tensor


def sinusoidal_positional_encoding(length: int, d_model: int) -> Tensor:
    """The fixed sin / cos table (length, d_model): pe[:, 2i] = sin(pos /
    10000^(2i/d)), pe[:, 2i+1] = cos of the same angle (SpeechBrain's
    PositionalEncoding), computed in float32 numpy as the JAX package
    computes it."""
    assert d_model % 2 == 0, "d_model must be even"
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


def _pe(length: int, d: int, like: Tensor) -> Tensor:
    return sinusoidal_positional_encoding(length, d).to(like.device,
                                                        like.dtype)


class _SBLayerNorm(nn.Module):
    """SpeechBrain's LayerNorm wrapper (key ``.norm``), eps 1e-6."""

    def __init__(self, d: int):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, x: Tensor) -> Tensor:
        return self.norm(x)


class _SBAttention(nn.Module):
    """SpeechBrain's MultiheadAttention wrapper (key ``.att``): torch's
    ``nn.MultiheadAttention`` as self-attention over (B, T, d)."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.att = nn.MultiheadAttention(d, heads, batch_first=True)

    def forward(self, x: Tensor) -> Tensor:
        return self.att(x, x, x, need_weights=False)[0]


class _SBFeedForward(nn.Module):
    """SpeechBrain's PositionalwiseFeedForward (keys ``.ffn.0`` /
    ``.ffn.3``): Linear, ReLU, Linear."""

    def __init__(self, d: int, d_ffn: int):
        super().__init__()
        self.ffn = nn.Sequential(nn.Linear(d, d_ffn), nn.ReLU(),
                                 nn.Dropout(0.0), nn.Linear(d_ffn, d))

    def forward(self, x: Tensor) -> Tensor:
        return self.ffn(x)


class SBTransformerLayer(nn.Module):
    """The pre-LN encoder layer (``normalize_before``): x + MHA(LN(x)),
    then x + FFN(LN(x))."""

    def __init__(self, d_model: int, n_heads: int, d_ffn: int):
        super().__init__()
        self.self_att = _SBAttention(d_model, n_heads)
        self.pos_ffn = _SBFeedForward(d_model, d_ffn)
        self.norm1 = _SBLayerNorm(d_model)
        self.norm2 = _SBLayerNorm(d_model)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.self_att(self.norm1(x))
        return x + self.pos_ffn(self.norm2(x))


class _SBEncoder(nn.Module):
    """SpeechBrain's TransformerEncoder: the layers, then a closing norm."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int,
                 d_ffn: int):
        super().__init__()
        self.layers = nn.ModuleList(
            SBTransformerLayer(d_model, n_heads, d_ffn)
            for _ in range(num_layers))
        self.norm = _SBLayerNorm(d_model)

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class SBTransformerBlock(nn.Module):
    """The positional encoding, then the encoder (key ``.mdl``), over
    (B, T, d)."""

    def __init__(self, num_layers: int, d_model: int, n_heads: int,
                 d_ffn: int, use_positional_encoding: bool = True):
        super().__init__()
        self.use_positional_encoding = use_positional_encoding
        self.mdl = _SBEncoder(num_layers, d_model, n_heads, d_ffn)

    def forward(self, x: Tensor) -> Tensor:
        if self.use_positional_encoding:
            x = x + _pe(x.shape[1], x.shape[2], x)
        return self.mdl(x)


class DualPathBlock(nn.Module):
    """One dual-computation block over (B, N, K, S) chunks (K the chunk
    length, S the chunk count): the intra-chunk transformer, norm, + the
    input; the inter-chunk transformer, norm, + the intra output."""

    def __init__(self, num_tf_layers: int, d_model: int, n_heads: int,
                 d_ffn: int):
        super().__init__()
        self.intra_mdl = SBTransformerBlock(num_tf_layers, d_model, n_heads,
                                            d_ffn)
        self.inter_mdl = SBTransformerBlock(num_tf_layers, d_model, n_heads,
                                            d_ffn)
        self.intra_norm = nn.GroupNorm(1, d_model, eps=1e-8)
        self.inter_norm = nn.GroupNorm(1, d_model, eps=1e-8)

    def forward(self, x: Tensor) -> Tensor:
        b, n, k, s = x.shape
        intra = self.intra_mdl(x.permute(0, 3, 2, 1).reshape(b * s, k, n))
        intra = intra.reshape(b, s, k, n).permute(0, 3, 2, 1)
        intra = self.intra_norm(intra) + x
        inter = self.inter_mdl(intra.permute(0, 2, 3, 1).reshape(b * k, s, n))
        inter = inter.reshape(b, k, s, n).permute(0, 3, 1, 2)
        return self.inter_norm(inter) + intra


def segment_chunks(x: Tensor, K: int) -> Tuple[Tensor, int]:
    """(B, L, N) -> (B, K, S, N) 50%-overlap chunks, and the zero ``gap``
    appended so that the chunks tile (SpeechBrain's _Segmentation,
    including its full extra K-chunk of zeros when L % K == K // 2: the
    padded chunk is seen by inter-chunk attention)."""
    b, L, n = x.shape
    P = K // 2
    gap = K - (P + L % K) % K
    x = F.pad(x, (0, 0, P, P + gap))
    x1 = x[:, :-P].reshape(b, -1, K, n)
    x2 = x[:, P:].reshape(b, -1, K, n)
    seg = torch.cat([x1, x2], dim=2).reshape(b, -1, K, n)
    return seg.transpose(1, 2), gap


def overlap_add_chunks(seg: Tensor, gap: int) -> Tensor:
    """(B, K, S, N) -> (B, L, N): the two 50%-overlap chunk streams summed
    back (SpeechBrain's _over_add), the gap cut."""
    b, K, s, n = seg.shape
    P = K // 2
    x = seg.transpose(1, 2).reshape(b, s // 2, 2 * K, n)
    x1 = x[:, :, :K].reshape(b, -1, n)[:, P:]
    x2 = x[:, :, K:].reshape(b, -1, n)[:, :-P]
    out = x1 + x2
    return out[:, :-gap] if gap else out


class SepFormerMaskNet(nn.Module):
    """SpeechBrain's Dual_Path_Model: (B, N, L) encoder features -> (B,
    num_spks, N, L) ReLU masks."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_spks: int = 2, chunk_size: int = 250,
                 num_dp_layers: int = 2, num_tf_layers: int = 8,
                 n_heads: int = 8, d_ffn: int = 1024,
                 use_global_pos_enc: bool = True):
        super().__init__()
        self.out_channels, self.num_spks = out_channels, num_spks
        self.chunk_size = chunk_size
        self.use_global_pos_enc = use_global_pos_enc
        self.norm = nn.GroupNorm(1, in_channels, eps=1e-8)
        self.conv1d = nn.Conv1d(in_channels, out_channels, 1, bias=False)
        self.dual_mdl = nn.ModuleList(
            DualPathBlock(num_tf_layers, out_channels, n_heads, d_ffn)
            for _ in range(num_dp_layers))
        self.prelu = nn.PReLU()
        self.conv2d = nn.Conv2d(out_channels, out_channels * num_spks, 1)
        self.output = nn.Sequential(
            nn.Conv1d(out_channels, out_channels, 1), nn.Tanh())
        self.output_gate = nn.Sequential(
            nn.Conv1d(out_channels, out_channels, 1), nn.Sigmoid())
        self.end_conv1x1 = nn.Conv1d(out_channels, in_channels, 1,
                                     bias=False)

    def forward(self, x: Tensor) -> Tensor:
        b, _, L = x.shape
        h = self.conv1d(self.norm(x))                      # (B, out, L)
        if self.use_global_pos_enc:
            # x = pos_enc(x) + x * sqrt(d)
            h = (_pe(L, self.out_channels, h).T[None]
                 + h * math.sqrt(self.out_channels))
        seg, gap = segment_chunks(h.transpose(1, 2), self.chunk_size)
        seg = seg.permute(0, 3, 1, 2)                      # (B, out, K, S)
        for blk in self.dual_mdl:
            seg = blk(seg)
        seg = self.conv2d(self.prelu(seg))                 # (B, out*spks, K, S)
        k, s = seg.shape[-2:]
        seg = seg.reshape(b * self.num_spks, self.out_channels, k, s)
        h = overlap_add_chunks(seg.permute(0, 2, 3, 1), gap).transpose(1, 2)
        h = self.output(h) * self.output_gate(h)
        h = F.relu(self.end_conv1x1(h))
        return h.reshape(b, self.num_spks, -1, L)


class _Encoder(nn.Module):
    """The strided conv (key ``.conv1d``) and ReLU: (B, T) -> (B, N, L)."""

    def __init__(self, channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.conv1d = nn.Conv1d(1, channels, kernel_size, stride=stride,
                                bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.conv1d(x[:, None]))


class SepFormer(nn.Module):
    """The SepFormer: ``forward(mix)``, mix (B, T) or (B, 1, T), -> (B,
    num_spks, T) float32 estimates. The defaults are the published
    sepformer-wsj02mix hyperparameters (256-wide encoder, kernel 16 /
    stride 8, chunk 250, 2 dual-path layers of 8-layer transformers with
    8 heads and 1024-wide FFNs). A stride that does not divide the kernel
    is refused, as the JAX package refuses it."""

    def __init__(self, num_spks: int = 2, enc_channels: int = 256,
                 out_channels: int = 256, kernel_size: int = 16,
                 stride: int = 8, chunk_size: int = 250,
                 num_dp_layers: int = 2, num_tf_layers: int = 8,
                 n_heads: int = 8, d_ffn: int = 1024,
                 use_global_pos_enc: bool = True):
        super().__init__()
        if kernel_size % stride:
            # the JAX package's decoder reshapes each kernel into
            # kernel_size // stride hop-`stride` frames
            raise ValueError(
                f"SepFormer requires stride ({stride}) to divide "
                f"kernel_size ({kernel_size}); the SpeechBrain config "
                "(16, 8) satisfies this")
        self.num_spks = num_spks
        self.encoder = _Encoder(enc_channels, kernel_size, stride)
        self.masknet = SepFormerMaskNet(
            enc_channels, out_channels, num_spks, chunk_size, num_dp_layers,
            num_tf_layers, n_heads, d_ffn, use_global_pos_enc)
        self.decoder = nn.ConvTranspose1d(enc_channels, 1, kernel_size,
                                          stride=stride, bias=False)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Every weight N(0, 1 / fan_in) (flax's lecun normal without its
        truncation), every bias 0, the norms' scales 1, PReLU 0.25."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("prelu.weight"):
                    p.fill_(0.25)
                elif name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif p.ndim == 1:
                    p.zero_()
                else:
                    # the decoder's flax kernel is (N, K): fan_in N
                    fan_in = (p.shape[0] if name == "decoder.weight"
                              else p[0].numel())
                    p.normal_(0.0, fan_in ** -0.5, generator=generator)

    def forward(self, mix: Tensor) -> Tensor:
        if mix.ndim == 3:
            mix = mix[:, 0]
        b, T = mix.shape
        h = self.encoder(mix)                              # (B, N, L)
        sep = h[:, None] * self.masknet(h)                 # (B, spks, N, L)
        y = self.decoder(sep.flatten(0, 1))[:, 0]
        t_est = y.shape[-1]
        y = y[..., :T] if t_est >= T else F.pad(y, (0, T - t_est))
        return y.reshape(b, self.num_spks, T)

    @staticmethod
    def params_from_jax(flat: Mapping[str, np.ndarray]
                        ) -> Dict[str, Tensor]:
        """The JAX package's flax tree ``{"a/b/c": array}`` -> this
        module's (SpeechBrain) state_dict keys and layouts: the inverse of
        the JAX importer's key map."""
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                for k, v in _flax_to_speechbrain(flat).items()}


_FLAX_LEAVES = {"scale": "weight", "bias": "bias"}


def _flax_to_speechbrain(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    tree: Dict[Tuple[str, ...], np.ndarray] = {
        tuple(p for p in k.split("/") if p != "params"): np.asarray(v)
        for k, v in flat.items()}
    out: Dict[str, np.ndarray] = {}
    mha: Dict[str, Dict[str, np.ndarray]] = {}
    for path, a in tree.items():
        key = "/".join(path)
        if key == "encoder/kernel":                 # (K, 1, N) -> (N, 1, K)
            out["encoder.conv1d.weight"] = a.transpose(2, 1, 0)
        elif key == "decoder":                      # (N, K) -> (N, 1, K)
            out["decoder.weight"] = a[:, None, :]
        elif key == "masknet/prelu/alpha":
            out["masknet.prelu.weight"] = a.reshape(1)
        elif path[:2] == ("masknet", "norm"):
            out[f"masknet.norm.{_FLAX_LEAVES[path[2]]}"] = a
        elif path[1:2] in (("conv1d",), ("end_conv1x1",)):  # (in, out)
            out[f"masknet.{path[1]}.weight"] = a.T[:, :, None]
        elif path[1:2] == ("conv2d",):
            out[f"masknet.conv2d.{_leaf(path[2])}"] = (
                a if path[2] == "bias" else a.T[:, :, None, None])
        elif path[1:2] in (("output",), ("output_gate",)):
            out[f"masknet.{path[1]}.0.{_leaf(path[2])}"] = (
                a if path[2] == "bias" else a.T[:, :, None])
        else:
            m = re.fullmatch(r"masknet/dual_(\d+)/(intra|inter)_(\w+?)/(.+)",
                             key)
            if m is None:
                raise KeyError(f"JAX parameter {key!r} has no SepFormer "
                               "counterpart")
            i, kind, what, rest = m.groups()
            base = f"masknet.dual_mdl.{i}.{kind}_"
            if what == "norm":
                out[base + f"norm.{_FLAX_LEAVES[rest]}"] = a
                continue
            r = rest.split("/")
            if r[0] == "norm":
                out[base + f"mdl.mdl.norm.norm.{_FLAX_LEAVES[r[1]]}"] = a
                continue
            lp = base + f"mdl.mdl.layers.{r[0][len('layer_'):]}"
            if r[1] in ("norm1", "norm2"):
                out[f"{lp}.{r[1]}.norm.{_FLAX_LEAVES[r[2]]}"] = a
            elif r[1] in ("ffn_1", "ffn_2"):
                idx = 0 if r[1] == "ffn_1" else 3
                out[f"{lp}.pos_ffn.ffn.{idx}.{_leaf(r[2])}"] = (
                    a.T if r[2] == "kernel" else a)
            else:  # self_att/{query,key,value,out}/{kernel,bias}
                mha.setdefault(lp, {})[f"{r[2]}/{r[3]}"] = a
    for lp, p in mha.items():
        d = p["out/bias"].shape[0]
        out[f"{lp}.self_att.att.in_proj_weight"] = np.concatenate(
            [p[f"{n}/kernel"].reshape(d, d).T
             for n in ("query", "key", "value")])
        out[f"{lp}.self_att.att.in_proj_bias"] = np.concatenate(
            [p[f"{n}/bias"].reshape(d) for n in ("query", "key", "value")])
        out[f"{lp}.self_att.att.out_proj.weight"] = p["out/kernel"].reshape(
            d, d).T
        out[f"{lp}.self_att.att.out_proj.bias"] = p["out/bias"]
    return out


def _leaf(name: str) -> str:
    return "weight" if name == "kernel" else name


def sepformer_params_from_torch(state: Mapping[str, object],
                                model: SepFormer) -> Dict[str, Tensor]:
    """A SpeechBrain SepFormer state dict -> ``model``'s state_dict: one
    flat dict with the ``encoder.`` / ``masknet.`` / ``decoder.`` prefixes
    (SpeechBrain saves the three modules apart; ``cli/sepformer_baseline``
    merges them), the JAX importer's input. Every key of ``model`` must be
    there at its shape (extra keys are ignored, as the JAX importer ignores
    them); returns float32 tensors for ``load_state_dict``."""
    want = model.state_dict()
    missing = sorted(k for k in want if k not in state)
    if missing:
        raise KeyError(f"SepFormer checkpoint lacks {len(missing)} keys: "
                       f"{missing[:5]}")
    out = {}
    for k, ref in want.items():
        v = torch.as_tensor(state[k]).detach().cpu().float()
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"SepFormer checkpoint key {k!r}: shape "
                             f"{tuple(v.shape)}, the model's "
                             f"{tuple(ref.shape)}")
        out[k] = v
    return out
