"""FACodec: the factorized neural speech codec of NaturalSpeech3 (port of
ditsep_tpu/models/facodec.py; reference: src/models/facodec/facodec.py:
159-680, quantize/fvq.py, gradient_reversal.py:11-35, alias_free_torch/).

An alternative codec off the separation path: DAC-style alias-free snake
encoder and decoder; three residual factorized-VQ groups (prosody,
content, and the acoustic residual that quantizes what the first two
leave); a timbre transformer pooled into a speaker embedding that FiLMs
decoding (voice conversion by ``decode_with_timbre``); F0 / uv / phone
heads and the optional gradient-reversal heads; ``vq2emb`` from codes.

Layouts: audio (B, 1, T) and the encoder's output (B, D, T / hop) as the
JAX package's; inside, the convs and the alias-free activations run NCW,
the quantizers, the timbre encoder and the heads' projections over
(B, T, D). The alias-free FIRs are depthwise ``F.conv1d`` /
``F.conv_transpose1d`` with replicate padding (the JAX package's
``lax.conv_general_dilated``; no kernel of the port's is on this path).

Modules carry flax's names (``block_{i}``, ``res_{j}``, ``act_0``,
``snake``, ``qkv_{i}``, ``vq_{i}``, ...), so a JAX tree crosses by
``models.weights.params_from_jax(flat, model)``; weight-normed Dense
layers hold ``weight_v`` (out, in) and ``weight_g`` (out, 1), as torch's
``weight_norm`` on a Linear.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch.models.oobleck import (
    SnakeBeta, WNConv1d, WNConvTranspose1d,
)
from ditsep_tpu_torch.models.transformer import (
    Conv1d, Dense, LayerNorm, Seeded,
)

Tensor = torch.Tensor


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def gradient_reversal(x: Tensor, alpha: float = 1.0) -> Tensor:
    """Identity forward, -alpha * grad backward (reference:
    gradient_reversal.py:11-35)."""
    return _GradientReversal.apply(x, alpha)


def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> np.ndarray:
    """Windowed-sinc lowpass with the adaptive Kaiser design rule
    (reference: alias_free_torch/filter.py:27-58): beta from the Kaiser
    attenuation estimate A = 2.285 (N - 1) pi (4 half_width) + 7.95, the
    taps normalised to unit sum; ``cutoff`` in cycles a sample (0..0.5).
    Float32 numpy taps, as the JAX package's."""
    if not 0.0 <= cutoff <= 0.5:
        raise ValueError("cutoff must be in [0, 0.5]")
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4.0 * half_width
    a = 2.285 * (half_size - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, np.float32)
    h = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _taps_on(cutoff: float, half_width: float, kernel_size: int,
             scale: float, flip: bool, device: torch.device,
             dtype: torch.dtype) -> Tensor:
    """The Kaiser-sinc taps times ``scale`` (reversed with ``flip``) as a
    (1, 1, k) tensor on ``device``, made once: the alias-free activations
    call them for every FIR, and a copy to the card each time would stall
    the host."""
    h = kaiser_sinc_filter1d(cutoff, half_width, kernel_size) * scale
    t = torch.from_numpy(np.ascontiguousarray(h[::-1] if flip else h))
    return t.to(device=device, dtype=dtype).view(1, 1, -1)


def _taps(x: Tensor, cutoff: float, half_width: float, kernel_size: int,
          scale: float = 1.0, flip: bool = False) -> Tensor:
    """Depthwise (C, 1, k) weights of the taps for ``x`` (B, C, T)."""
    t = _taps_on(cutoff, half_width, kernel_size, scale, flip, x.device,
                 x.dtype)
    return t.expand(x.shape[1], 1, -1)


def lowpass_filter1d(x: Tensor, cutoff: float = 0.5, half_width: float = 0.6,
                     stride: int = 1, kernel_size: int = 12) -> Tensor:
    """LowPassFilter1d (reference: filter.py:61-96) over (B, C, T): the
    depthwise Kaiser-sinc FIR after edge padding (same length at stride
    1)."""
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    # a convolution: flax's conv_general_dilated with the taps reversed
    return F.conv1d(x, _taps(x, cutoff, half_width, kernel_size, flip=True),
                    stride=stride, groups=x.shape[1])


def upsample1d(x: Tensor, ratio: int = 2,
               kernel_size: Optional[int] = None) -> Tensor:
    """Alias-free ratio-x upsampling, zero-stuffing and Kaiser-sinc
    interpolation (reference: resample.py:9-37): (B, C, T) -> (B, C,
    ratio T)."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    pad = k // ratio - 1
    x = F.pad(x, (pad, pad), mode="replicate")
    # the JAX package's input-dilated conv padded k - 1 each side is a
    # transposed conv with the taps as they are: (T - 1) ratio + k samples
    taps = _taps(x, 0.5 / ratio, 0.6 / ratio, k, scale=float(ratio))
    y = F.conv_transpose1d(x, taps, stride=ratio, groups=x.shape[1])
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    return y[..., pad_left:y.shape[-1] - pad_right]


def downsample1d(x: Tensor, ratio: int = 2,
                 kernel_size: Optional[int] = None) -> Tensor:
    """Alias-free ratio-x downsampling (reference: resample.py:40-57)."""
    k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
    return lowpass_filter1d(x, 0.5 / ratio, 0.6 / ratio, stride=ratio,
                            kernel_size=k)


class AliasFreeActivation1d(nn.Module):
    """Kaiser-sinc upsample 2x, SnakeBeta, downsample 2x (reference:
    alias_free_torch/act.py:7): the FIR pair band-limits the signal so the
    nonlinearity's harmonics do not alias. (B, C, T) -> (B, C, T)."""

    def __init__(self, channels: int, ratio: int = 2):
        super().__init__()
        self.ratio = ratio
        self.snake = SnakeBeta(channels)

    def forward(self, x: Tensor) -> Tensor:
        t = x.shape[-1]
        up = upsample1d(x, self.ratio)
        down = downsample1d(self.snake(up), self.ratio)
        return down[..., :t]


class FACodecResUnit(nn.Module):
    """act, dilated k = 7 conv, act, k = 1 conv, plus the input (reference:
    facodec.py ResidualUnit). NCW."""

    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.act_0 = AliasFreeActivation1d(channels)
        self.conv_0 = WNConv1d(channels, channels, 7, dilation=dilation,
                               padding=(dilation * 6) // 2)
        self.act_1 = AliasFreeActivation1d(channels)
        self.conv_1 = WNConv1d(channels, channels, 1, padding=0)

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv_1(self.act_1(self.conv_0(self.act_0(x))))
        return x + h


class FACodecEncoderBlock(nn.Module):
    """Residual units of dilation 1, 3, 9, act, strided k = 2s conv."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"res_{i}", FACodecResUnit(in_ch, d))
        self.act = AliasFreeActivation1d(in_ch)
        self.down = WNConv1d(in_ch, out_ch, 2 * stride, stride=stride,
                             padding=math.ceil(stride / 2))

    def forward(self, x: Tensor) -> Tensor:
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        return self.down(self.act(x))


class FACodecEncoder(Seeded):
    """(reference: facodec.py:159-215) (B, 1, T) -> (B, out_channels,
    T / hop), hop the product of ``up_ratios``."""

    def __init__(self, ngf: int = 32, up_ratios: Sequence[int] = (2, 4, 5, 5),
                 out_channels: int = 256, in_channels: int = 1):
        super().__init__()
        self.up_ratios = tuple(int(s) for s in up_ratios)
        d = ngf
        self.stem = WNConv1d(in_channels, d, 7, padding=3)
        for i, s in enumerate(self.up_ratios):
            self.add_module(f"block_{i}", FACodecEncoderBlock(d, 2 * d, s))
            d *= 2
        self.act = AliasFreeActivation1d(d)
        self.head = WNConv1d(d, out_channels, 3, padding=1)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.up_ratios))

    def forward(self, x: Tensor) -> Tensor:
        h = self.stem(x)
        for i in range(len(self.up_ratios)):
            h = getattr(self, f"block_{i}")(h)
        return self.head(self.act(h))


class FACodecDecoderBlock(nn.Module):
    """(reference: facodec.py:222-241 DecoderBlock) act, transposed conv
    (kernel 2s, padding ceil(s / 2), output_padding s % 2), residual units
    of dilation 1, 3, 9."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.act = AliasFreeActivation1d(in_ch)
        self.up = WNConvTranspose1d(in_ch, out_ch, 2 * stride, stride=stride,
                                    padding=math.ceil(stride / 2),
                                    output_padding=stride % 2)
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"res_{i}", FACodecResUnit(out_ch, d))

    def forward(self, x: Tensor) -> Tensor:
        x = self.up(self.act(x))
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        return x


class FacodecTimbreEncoder(Seeded):
    """The timbre transformer over encoder frames (reference:
    src/models/facodec/transformer.py:154-234): pre-norm self-attention
    with a fused qkv projection, a FastSpeech-style conv FFN, a final
    LayerNorm. (B, T, D) -> (B, T, D).

    The reference's PositionalEncoding adds ``pe[:batch]`` to batch-first
    input (transformer.py:49-51), so each item gets the sinusoid of its
    batch index, constant over time: kept as it is, as the JAX package
    keeps it. No dropout (inference and import parity)."""

    def __init__(self, hidden: int = 256, num_layers: int = 4,
                 num_heads: int = 4, filter_size: int = 1024,
                 kernel_size: int = 5):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        self.num_heads = num_heads
        for i in range(num_layers):
            self.add_module(f"ln1_{i}", LayerNorm(hidden, eps=1e-5))
            self.add_module(f"qkv_{i}", Dense(hidden, 3 * hidden))
            self.add_module(f"out_{i}", Dense(hidden, hidden))
            self.add_module(f"ln2_{i}", LayerNorm(hidden, eps=1e-5))
            self.add_module(f"ffn1_{i}", Conv1d(
                hidden, filter_size, kernel_size,
                padding=(kernel_size // 2, kernel_size // 2)))
            self.add_module(f"ffn2_{i}", Dense(filter_size, hidden))
        self.ln_out = LayerNorm(hidden, eps=1e-5)

    def _attention(self, i: int, x: Tensor) -> Tensor:
        b, t, d = x.shape
        h = self.num_heads
        dh = d // h
        q, k, v = getattr(self, f"qkv_{i}")(x).split(d, dim=-1)
        q, k, v = (a.reshape(b, t, h, dh).transpose(1, 2) for a in (q, k, v))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(dh)
        out = torch.einsum("bhqk,bhkd->bhqd", scores.softmax(-1), v)
        return getattr(self, f"out_{i}")(out.transpose(1, 2).reshape(b, t, d))

    def forward(self, x: Tensor) -> Tensor:
        b, d = x.shape[0], x.shape[2]
        if d != self.hidden:
            raise ValueError(f"timbre encoder width {self.hidden}, input {d}")
        pos = torch.arange(b, device=x.device, dtype=torch.float32)[:, None] \
            * torch.exp(torch.arange(0, d, 2, device=x.device,
                                     dtype=torch.float32)
                        * (-math.log(10000.0) / d))[None, :]
        pe = torch.zeros(b, d, device=x.device, dtype=torch.float32)
        pe[:, 0::2] = torch.sin(pos)
        pe[:, 1::2] = torch.cos(pos)
        x = x + pe[:, None, :].to(x.dtype)
        for i in range(self.num_layers):
            x = x + self._attention(i, getattr(self, f"ln1_{i}")(x))
            f = getattr(self, f"ln2_{i}")(x)
            f = getattr(self, f"ffn1_{i}")(f.transpose(1, 2)).transpose(1, 2)
            x = x + getattr(self, f"ffn2_{i}")(F.relu(f))
        return self.ln_out(x)


class WNDense(nn.Module):
    """Weight-normalized Linear as torch's ``weight_norm(nn.Linear)``:
    ``weight_v`` (out, in), ``weight_g`` (out, 1), the norm over the input
    axis per output unit (1e-12 under the square root, as the JAX
    package's)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim))
        self.weight_g = nn.Parameter(torch.empty(out_dim, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """v ~ U(+-1/sqrt(in)) (torch's Linear default), g = ||v||, bias
        0."""
        bound = 1.0 / math.sqrt(self.weight_v.shape[1])
        with torch.no_grad():
            self.weight_v.uniform_(-bound, bound, generator=generator)
            self.weight_g.copy_(self.weight_v.norm(dim=1, keepdim=True))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        v = self.weight_v.float()
        w = v / torch.sqrt((v ** 2).sum(dim=1, keepdim=True) + 1e-12) \
            * self.weight_g.float()
        return F.linear(x, w.to(x.dtype), self.bias)


def _l2_normalize(x: Tensor) -> Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class FactorizedVQ(nn.Module):
    """Factorized VQ (reference: quantize/fvq.py:16-120): a weight-normed
    projection into the codebook space, the nearest code by cosine (the
    argmax over l2-normalised rows), the RAW codebook row as the code
    (fvq.py:116-120), straight-through, the projection back. The
    commitment and codebook losses (per-item means, fvq.py:66-74) only
    when ``train``; zeros otherwise."""

    def __init__(self, dim: int, codebook_size: int = 1024,
                 codebook_dim: int = 8, commitment: float = 0.005):
        super().__init__()
        self.commitment = commitment
        self.proj_in = WNDense(dim, codebook_dim)
        self.proj_out = WNDense(codebook_dim, dim)
        self.codebook = nn.Parameter(torch.empty(codebook_size, codebook_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.codebook.normal_(0.0, 1.0, generator=generator)

    def scores(self, z_e: Tensor) -> Tensor:
        """Cosine of each projected row with each code: (..., size)."""
        return _l2_normalize(z_e) @ _l2_normalize(self.codebook).T

    def forward(self, x: Tensor, train: bool = False
                ) -> Tuple[Tensor, Tensor, Tensor]:
        """x (B, T, D) -> (quantized (B, T, D), codes (B, T), loss (B,))."""
        z_e = self.proj_in(x)
        idx = self.scores(z_e).argmax(-1)
        z_q = self.codebook[idx]
        if train:
            commit = self.commitment * ((z_e - z_q.detach()) ** 2).mean((1, 2))
            codebook_loss = ((z_q - z_e.detach()) ** 2).mean((1, 2))
            loss = commit + codebook_loss
        else:
            loss = x.new_zeros(x.shape[0])
        z_st = z_e + (z_q - z_e).detach()
        return self.proj_out(z_st), idx, loss

    def lookup(self, idx: Tensor) -> Tensor:
        """Codes (B, T) -> (B, T, D) (reference: fvq.py:86-90)."""
        return self.proj_out(self.codebook[idx])


class FacodecRVQ(nn.Module):
    """A residual stack of factorized VQs (reference: quantize/rvq.py:
    12-73): layer i quantizes what layers < i leave; the outputs sum."""

    def __init__(self, num_quantizers: int, dim: int,
                 codebook_size: int = 1024, codebook_dim: int = 8,
                 commitment: float = 0.005):
        super().__init__()
        self.num_quantizers = num_quantizers
        for i in range(num_quantizers):
            self.add_module(f"vq_{i}", FactorizedVQ(
                dim, codebook_size, codebook_dim, commitment))

    def layer(self, i: int) -> FactorizedVQ:
        return getattr(self, f"vq_{i}")

    def forward(self, x: Tensor, n_quantizers: Optional[int] = None,
                train: bool = False):
        """x (B, T, D) -> (quantized, codes (nq, B, T), losses (nq,));
        ``n_quantizers`` caps the depth (rvq.py:50-51); each loss a batch
        mean (rvq.py:64-66)."""
        n = self.num_quantizers if n_quantizers is None else min(
            int(n_quantizers), self.num_quantizers)
        out = torch.zeros_like(x)
        residual = x
        codes, losses = [], []
        for i in range(n):
            q, idx, loss = self.layer(i)(residual, train=train)
            residual = residual - q
            out = out + q
            codes.append(idx)
            losses.append(loss.mean())
        return out, torch.stack(codes), torch.stack(losses)

    def lookup(self, codes: Tensor) -> Tensor:
        """(nq, B, T) codes -> summed embeddings (B, T, D) (rvq.py:75-82)."""
        out = 0.0
        for i in range(min(codes.shape[0], self.num_quantizers)):
            out = out + self.layer(i).lookup(codes[i])
        return out


class CNNLSTMHead(nn.Module):
    """Frame or utterance predictor (reference: facodec.py:37-57 CNNLSTM,
    which holds no LSTM): residual units of dilation 1, 2, 3, act, one
    Dense a head. Input (B, T, D); ``global_pred`` means over time before
    the heads. Returns a tuple of (B, T, out) (or (B, out))."""

    def __init__(self, dim: int, out_dim: int, num_heads: int = 1,
                 global_pred: bool = False):
        super().__init__()
        self.num_heads, self.global_pred = num_heads, global_pred
        for i, dil in enumerate((1, 2, 3)):
            self.add_module(f"res_{i}", FACodecResUnit(dim, dil))
        self.act = AliasFreeActivation1d(dim)
        for i in range(num_heads):
            self.add_module(f"head_{i}", Dense(dim, out_dim))

    def forward(self, x: Tensor):
        x = x.transpose(1, 2)
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        x = self.act(x).transpose(1, 2)
        if self.global_pred:
            x = x.mean(1)
        return tuple(getattr(self, f"head_{i}")(x)
                     for i in range(self.num_heads))


class FACodecDecoder(Seeded):
    """Grouped quantization and timbre-conditioned decoding (reference:
    facodec.py:244-601): the prosody (``vq_num_q_p``) and content
    (``vq_num_q_c``) groups quantize the encoder output, the residual group
    (``vq_num_q_r``) what they leave. Decoding FiLMs the detached prosody
    and content sum, plus the residual (randomly masked in ``train``),
    with a speaker embedding mean-pooled from the timbre transformer, then
    upsamples through alias-free snake blocks to audio. The F0 / uv and
    phone heads and the gradient-reversal heads mirror facodec.py:
    374-407 / 477-511; ``decode_with_timbre`` is the reference's voice
    conversion (facodec.py:570-578)."""

    def __init__(self, in_channels: int = 256, ngf: int = 32,
                 up_ratios: Sequence[int] = (5, 5, 4, 2),
                 upsample_initial_channel: Optional[int] = None,
                 vq_num_q_p: int = 1, vq_num_q_c: int = 2,
                 vq_num_q_r: int = 3, codebook_size: int = 1024,
                 codebook_dim: int = 8, phone_classes: int = 5003,
                 timbre_layers: int = 4, timbre_heads: int = 4,
                 gr_alpha: float = 1.0, use_gr_content_f0: bool = False,
                 use_gr_prosody_phone: bool = False,
                 use_gr_residual_f0: bool = False,
                 use_gr_residual_phone: bool = False,
                 use_gr_x_timbre: bool = False, num_speakers: int = 0,
                 prob_random_mask_residual: float = 0.75):
        super().__init__()
        D = in_channels
        self.in_channels, self.up_ratios = D, tuple(int(s) for s in up_ratios)
        self.vq_num_q_p, self.vq_num_q_c = vq_num_q_p, vq_num_q_c
        self.vq_num_q_r, self.timbre_layers = vq_num_q_r, timbre_layers
        self.gr_alpha = gr_alpha
        self.use_gr_content_f0 = use_gr_content_f0
        self.use_gr_prosody_phone = use_gr_prosody_phone
        self.use_gr_residual_f0 = use_gr_residual_f0
        self.use_gr_residual_phone = use_gr_residual_phone
        self.use_gr_x_timbre = use_gr_x_timbre
        self.prob_random_mask_residual = prob_random_mask_residual
        self.q_prosody = FacodecRVQ(vq_num_q_p, D, codebook_size,
                                    codebook_dim)
        self.q_content = FacodecRVQ(vq_num_q_c, D, codebook_size,
                                    codebook_dim)
        if vq_num_q_r > 0:
            self.q_residual = FacodecRVQ(vq_num_q_r, D, codebook_size,
                                         codebook_dim)
        self.timbre_encoder = FacodecTimbreEncoder(
            hidden=D, num_layers=timbre_layers, num_heads=timbre_heads)
        self.timbre_film = Dense(D, 2 * D)
        self.f0_head = CNNLSTMHead(D, 1, num_heads=2)
        self.phone_head = CNNLSTMHead(D, phone_classes, num_heads=1)
        if use_gr_content_f0:
            self.content_f0_head = CNNLSTMHead(D, 1, num_heads=2)
        if use_gr_prosody_phone:
            self.prosody_phone_head = CNNLSTMHead(D, phone_classes)
        if vq_num_q_r > 0 and use_gr_residual_f0:
            self.res_f0_head = CNNLSTMHead(D, 1, num_heads=2)
        if vq_num_q_r > 0 and use_gr_residual_phone:
            self.res_phone_head = CNNLSTMHead(D, phone_classes)
        if use_gr_x_timbre:
            if num_speakers <= 0:
                raise ValueError("the x-timbre GR head needs num_speakers")
            self.x_timbre_head = CNNLSTMHead(D, num_speakers,
                                             global_pred=True)
        d = (upsample_initial_channel if upsample_initial_channel is not None
             else ngf * 2 ** len(self.up_ratios))
        self.dec_stem = WNConv1d(D, d, 7, padding=3)
        for i, s in enumerate(self.up_ratios):
            self.add_module(f"dec_block_{i}",
                            FACodecDecoderBlock(d, d // 2, s))
            d //= 2
        self.dec_act = AliasFreeActivation1d(d)
        self.dec_head = WNConv1d(d, 1, 7, padding=3)
        self._film_bias()

    def _film_bias(self) -> None:
        """The FiLM's bias starts as (ones | zeros): gamma 1, beta 0."""
        D = self.in_channels
        with torch.no_grad():
            self.timbre_film.bias[:D].fill_(1.0)
            self.timbre_film.bias[D:].zero_()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        self._film_bias()

    @property
    def num_quantizers(self) -> int:
        return self.vq_num_q_p + self.vq_num_q_c + self.vq_num_q_r

    def quantize(self, x: Tensor, n_quantizers: Optional[int] = None,
                 train: bool = False):
        """x (B, T, D) -> (the sum, codes (nq_total, B, T), losses
        (nq_total,), [q_p, q_c, (q_r)] the groups' sums) (reference:
        facodec.py:410-448)."""
        qp, cp, lp = self.q_prosody(x, n_quantizers, train=train)
        qc, cc, lc = self.q_content(x, n_quantizers, train=train)
        outs, codes, losses, groups = qp + qc, [cp, cc], [lp, lc], [qp, qc]
        if self.vq_num_q_r > 0:
            res_in = x - (qp + qc).detach()
            qr, cr, lr = self.q_residual(res_in, n_quantizers, train=train)
            outs = outs + qr
            codes.append(cr)
            losses.append(lr)
            groups.append(qr)
        return outs, torch.cat(codes), torch.cat(losses), groups

    def _decode_core(self, z: Tensor, spk: Tensor) -> Tensor:
        """FiLM by the speaker embedding, then the upsampling stack
        (reference: facodec.py:513-556): z (B, T, D) -> (B, 1, T hop)."""
        D = z.shape[-1]
        style = self.timbre_film(spk)
        gamma, beta = style[:, None, :D], style[:, None, D:]
        mean = z.mean(-1, keepdim=True)
        var = ((z - mean) ** 2).mean(-1, keepdim=True)
        z = (z - mean) * torch.rsqrt(var + 1e-5)  # LN without affine
        z = (z * gamma + beta).transpose(1, 2)
        z = self.dec_stem(z)
        for i in range(len(self.up_ratios)):
            z = getattr(self, f"dec_block_{i}")(z)
        return torch.tanh(self.dec_head(self.dec_act(z)))

    def forward(self, h: Tensor, *, speaker_embedding: Optional[Tensor] = None,
                n_quantizers: Optional[int] = None, train: bool = False,
                return_info: bool = False,
                generator: Optional[torch.Generator] = None,
                keep: Optional[Tensor] = None):
        """h, the encoder's output (B, D, T) -> audio (B, 1, T hop).

        ``return_info`` adds a dict: the codes and losses, the pooled
        speaker embedding, the F0 / uv / phone predictions and any enabled
        gradient-reversal head's. ``train`` masks the residual group per
        item with probability ``prob_random_mask_residual`` (reference:
        facodec.py:515-540): the keep mask (B, 1, 1) is ``keep`` when
        given (e.g. the JAX package's ``rvq_mask`` draw), else drawn from
        ``generator``."""
        x = h.transpose(1, 2)
        _, codes, losses, groups = self.quantize(x, n_quantizers,
                                                 train=train)
        spk_from_x = self.timbre_encoder(x).mean(1)
        spk = spk_from_x if speaker_embedding is None else speaker_embedding
        info = {"vq_loss": losses.sum(), "vq_losses": losses,
                "indices": codes.movedim(0, -1), "codes": codes,
                "spk_embs": spk_from_x}
        f0, uv = self.f0_head(groups[0])
        info["f0"], info["uv"] = f0[..., 0], uv[..., 0]
        (info["phone"],) = self.phone_head(groups[1])
        a = self.gr_alpha
        if self.use_gr_prosody_phone:
            (info["prosody_phone"],) = self.prosody_phone_head(
                gradient_reversal(groups[0], a))
        if self.use_gr_content_f0:
            cf0, cuv = self.content_f0_head(gradient_reversal(groups[1], a))
            info["content_f0"], info["content_uv"] = cf0[..., 0], cuv[..., 0]
        if self.vq_num_q_r > 0 and self.use_gr_residual_f0:
            rf0, ruv = self.res_f0_head(gradient_reversal(groups[2], a))
            info["res_f0"], info["res_uv"] = rf0[..., 0], ruv[..., 0]
        if self.vq_num_q_r > 0 and self.use_gr_residual_phone:
            (info["res_phone"],) = self.res_phone_head(
                gradient_reversal(groups[2], a))
        z = groups[0].detach() + groups[1].detach()
        if self.vq_num_q_r > 0:
            qr = groups[2]
            if train and self.prob_random_mask_residual > 0:
                if keep is None:
                    dev = qr.device if generator is None else generator.device
                    keep = torch.rand((qr.shape[0], 1, 1), generator=generator,
                                      device=dev) \
                        < 1.0 - self.prob_random_mask_residual
                qr = qr * keep.to(qr)
            z = z + qr
        if self.use_gr_x_timbre:
            (info["x_timbre"],) = self.x_timbre_head(gradient_reversal(z, a))
        audio = self._decode_core(z, spk)
        return (audio, info) if return_info else audio

    def vq2emb(self, codes: Tensor) -> Tensor:
        """Codes (nq_total, B, T) -> the summed embedding (B, D, T)
        (reference: facodec.py:558-568)."""
        p, c = self.vq_num_q_p, self.vq_num_q_c
        out = self.q_prosody.lookup(codes[:p])
        out = out + self.q_content.lookup(codes[p:p + c])
        if self.vq_num_q_r > 0 and codes.shape[0] > p + c:
            out = out + self.q_residual.lookup(codes[p + c:])
        return out.transpose(1, 2)

    def decode_with_timbre(self, z: Tensor, speaker_embedding: Tensor
                           ) -> Tensor:
        """Voice conversion: decode an embedding (B, D, T) under another
        speaker's embedding (reference: facodec.py:570-578)."""
        return self._decode_core(z.transpose(1, 2), speaker_embedding)


__all__ = ["AliasFreeActivation1d", "CNNLSTMHead", "FACodecDecoder",
           "FACodecDecoderBlock", "FACodecEncoder", "FACodecEncoderBlock",
           "FACodecResUnit", "FacodecRVQ", "FacodecTimbreEncoder",
           "FactorizedVQ", "WNDense", "downsample1d", "gradient_reversal",
           "kaiser_sinc_filter1d", "lowpass_filter1d", "upsample1d"]
