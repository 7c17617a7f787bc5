"""GAN discriminators and their losses, for the VAE-GAN trainer and the
LDM decoder finetune (port of ditsep_tpu/models/discriminators.py;
reference: stable-audio-tools models/discriminators.py and
models/encodec.py:38-151): the Encodec multi-scale complex-STFT
discriminator, the Oobleck multi-scale waveform convnet, the HiFi-GAN
period discriminator, DAC's MPD / MSD / MRD and its combination, the
constant-Q discriminator and BigVGAN's MPD + CQT; the hinge and
feature-matching losses and DAC's least-squares ``dac_gan_loss``.

Layout: NCHW (NCW for the 1-D convnets). The JAX package runs NHWC
with H the time (or frame) axis, so here H is that axis too: the
Encodec discriminator's (3, 9) kernel spans 3 frames by 9 bins, the
period discriminators' (5, 1) kernel 5 folded frames of one phase. The
Encodec STFT's channels stack as ``[real_0, ..., real_{C-1}, imag_0,
..., imag_{C-1}]``; MRD and CQT fold the audio channels into the batch
and carry (real, imag) as their 2 channels.

Weight normalization is an explicit (g, v) pair, ``w = v / sqrt(sum(v^2)
+ 1e-12) * g`` with the sum over all axes but the output channel, in the
reference's torch layouts: ``weight_v`` (out, in, kh, kw), ``weight_g``
(out, 1, 1, 1) (the 1-D convs are ``oobleck.WNConv1d``). Each family
carries the flax child names in ``flax_names``, so that
``models.weights.params_from_jax(flat, disc)`` loads a JAX tree
(``p{p}_conv_{i}``, ``mpd_{p}``, ``msd_{r}``, ``mrd_{f}``,
``band{bi}_conv_{i}``, ``scale_{i}``, ``conv_out``, ``cqt``);
``models/weights.py:disc_params_{from,to}_jax`` carry the Encodec tree
(``disc_{i}/conv_{j}/{v,g,bias}``) across.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.models.oobleck import WNConv1d
from ditsep_tpu_torch.ops.stft import stft as stft_fn

Tensor = torch.Tensor


class WNConv2d(nn.Module):
    """Weight-normalized Conv2d; ``padding`` None pads (k - 1) * d // 2 on
    each axis."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1),
                 dilation: Tuple[int, int] = (1, 1),
                 padding: Optional[Tuple[int, int]] = None):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.dilation = tuple(stride), tuple(dilation)
        self.padding = (tuple(padding) if padding is not None else
                        ((kh - 1) * dilation[0] // 2,
                         (kw - 1) * dilation[1] // 2))
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw))
        self.weight_g = nn.Parameter(torch.empty(out_ch, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """v ~ U(+-1/sqrt(fan_in)), fan_in = in * kh * kw (flax's
        variance_scaling(1/3, fan_in, uniform), torch's Conv2d default),
        g = ||v||, bias 0."""
        v, g = self.weight_v, self.weight_g
        bound = math.sqrt(1.0 / (v.shape[1] * v.shape[2] * v.shape[3]))
        with torch.no_grad():
            v.uniform_(-bound, bound, generator=generator)
            g.copy_(torch.sqrt((v ** 2).sum(dim=(1, 2, 3), keepdim=True)))
            self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        v = self.weight_v
        norm = torch.sqrt((v ** 2).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
        return F.conv2d(x, v / norm * self.weight_g, self.bias,
                        stride=self.stride, padding=self.padding,
                        dilation=self.dilation)


class Discriminator(nn.Module):
    """The families' common part: ``reset_parameters`` (re)initialises
    every weight-normed conv from ``generator``, in module order."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (WNConv1d, WNConv2d)):
                m.reset_parameters(generator)


class DiscriminatorSTFT(nn.Module):
    """One scale: complex STFT (center=False, window-normalized) -> a
    (3, 9) conv, three strided dilated ones, a (3, 3) one (each followed
    by LeakyReLU 0.2, its output a feature map) -> the (3, 3) logit
    conv. (B, C, T) -> (logits (B, out, frames, bins'), feature maps)."""

    def __init__(self, filters: int = 64, in_channels: int = 1,
                 out_channels: int = 1, n_fft: int = 1024,
                 hop_length: int = 256, kernel_size: Tuple[int, int] = (3, 9),
                 dilations: Sequence[int] = (1, 2, 4),
                 stride: Tuple[int, int] = (1, 2), max_filters: int = 1024,
                 filters_scale: int = 1):
        super().__init__()
        self.n_fft, self.hop_length = n_fft, hop_length
        ks = tuple(kernel_size)
        convs = [WNConv2d(2 * in_channels, filters, ks)]
        ch = filters
        for i, d in enumerate(dilations):
            out = min(filters_scale ** (i + 1) * filters, max_filters)
            convs.append(WNConv2d(ch, out, ks, stride=stride,
                                  dilation=(d, 1)))
            ch = out
        out = min(filters_scale ** (len(dilations) + 1) * filters,
                  max_filters)
        convs.append(WNConv2d(ch, out, (ks[0], ks[0])))
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv2d(out, out_channels, (ks[0], ks[0]))

    def forward(self, x: Tensor) -> Tuple[Tensor, List[Tensor]]:
        spec = stft_fn(x, n_fft=self.n_fft, hop_length=self.hop_length,
                       center=False, normalized=True)  # (B, C, F, frames)
        z = torch.cat([spec.real, spec.imag], dim=1).transpose(-1, -2)
        fmap = []
        for conv in self.convs:
            z = F.leaky_relu(conv(z), 0.2)
            fmap.append(z)
        return self.conv_post(z), fmap


class MultiScaleSTFTDiscriminator(Discriminator):
    """One DiscriminatorSTFT per (n_fft, hop); the defaults are the
    oobleck_finetune discriminator config. Returns (logits, feature maps),
    a list of each scale's."""

    def __init__(self, filters: int = 64, in_channels: int = 1,
                 out_channels: int = 1,
                 n_ffts: Sequence[int] = (2048, 1024, 512, 256, 128),
                 hop_lengths: Sequence[int] = (512, 256, 128, 64, 32)):
        super().__init__()
        self.discs = nn.ModuleList(
            DiscriminatorSTFT(filters=filters, in_channels=in_channels,
                              out_channels=out_channels, n_fft=n, hop_length=h)
            for n, h in zip(n_ffts, hop_lengths))

    def forward(self, x: Tensor) -> Tuple[List[Tensor], List[List[Tensor]]]:
        logits, fmaps = [], []
        for disc in self.discs:
            lg, fm = disc(x)
            logits.append(lg)
            fmaps.append(fm)
        return logits, fmaps


def hinge_terms(score_real: Tensor, score_fake: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """The hinge discriminator loss's reals' and fakes' terms."""
    return F.relu(1.0 - score_real).mean(), F.relu(1.0 + score_fake).mean()


def hinge_losses(score_real: Tensor, score_fake: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """(discriminator loss, generator loss) of the hinge GAN."""
    gen_loss = -score_fake.mean()
    real, fake = hinge_terms(score_real, score_fake)
    return real + fake, gen_loss


def encodec_discriminator_loss(disc: nn.Module,
                               reals: Tensor, fakes: Tensor,
                               normalize_losses: bool = False
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Hinge adversarial and feature-matching losses of a (logits, feature
    maps) discriminator (Encodec, Oobleck, the period discriminator),
    averaged over its scales: (dis_loss, adv_loss,
    feature_matching_distance). The feature
    matching is the mean |real - fake| of each feature map, averaged over
    a scale's maps (each divided by mean |real| + 1e-3 with
    ``normalize_losses``)."""
    logits_true, feats_true = disc(reals)
    logits_fake, feats_fake = disc(fakes)
    n = len(logits_true)
    dis_loss = adv_loss = fm = 0.0
    for i in range(n):
        terms = [(a - b).abs().mean() for a, b in zip(feats_true[i],
                                                       feats_fake[i])]
        if normalize_losses:
            # the denominator is a whole-batch mean: a shard's would
            # differ from the global batch's
            if parallel.couples_batch("normalize_losses") is not None:
                raise NotImplementedError(
                    "normalize_losses=True divides by a whole-batch mean; "
                    "it is not run data-parallel")
            terms = [t / (a.abs().mean() + 1e-3)
                     for t, a in zip(terms, feats_true[i])]
        fm = fm + sum(terms) / len(terms)
        d, a = hinge_losses(logits_true[i], logits_fake[i])
        dis_loss = dis_loss + d
        adv_loss = adv_loss + a
    return dis_loss / n, adv_loss / n, fm / n


class SharedDiscriminatorConvNet1d(Discriminator):
    """The Oobleck / RAVE-style waveform convnet (reference:
    discriminators.py:70-121): ``n_layers`` weight-normed strided convs
    (capacity x 2^i channels), each output a feature map before its SiLU,
    then a k=1 conv to ``out_size``. (B, C, T) -> (score (B,), feature
    maps)."""

    def __init__(self, in_channels: int = 1, capacity: int = 32,
                 n_layers: int = 4, kernel_size: int = 15, stride: int = 4,
                 out_size: int = 1):
        super().__init__()
        chs = [in_channels] + [capacity * 2 ** i for i in range(n_layers)]
        self.convs = nn.ModuleList(
            WNConv1d(a, b, kernel_size, stride=stride,
                     padding=kernel_size // 2)
            for a, b in zip(chs[:-1], chs[1:]))
        self.conv_out = WNConv1d(chs[-1], out_size, 1, padding=0)
        self.flax_names = {f"conv_{i}": f"convs.{i}"
                           for i in range(n_layers)}

    def forward(self, x: Tensor) -> Tuple[Tensor, List[Tensor]]:
        feats, h = [], x
        for conv in self.convs:
            h = conv(h)
            feats.append(h)
            h = F.silu(h)
        h = self.conv_out(h)
        feats.append(h)
        return h.reshape(h.shape[0], -1).mean(-1), feats


def _halve(x: Tensor, rate: int = 2) -> Tensor:
    """Average pooling of the last axis by ``rate``, an odd tail cut."""
    t = x.shape[-1] - x.shape[-1] % rate
    return x[..., :t].reshape(x.shape[:-1] + (t // rate, rate)).mean(-1)


class OobleckDiscriminator(Discriminator):
    """The same convnet at ``n_scales`` successively halved rates, scores
    summed (reference: discriminators.py:124-146, 207-240). Returns
    ([score (B, 1, 1)], [every scale's feature maps])."""

    def __init__(self, in_channels: int = 1, n_scales: int = 3,
                 capacity: int = 32):
        super().__init__()
        self.scales = nn.ModuleList(
            SharedDiscriminatorConvNet1d(in_channels, capacity)
            for _ in range(n_scales))
        self.flax_names = {f"scale_{i}": f"scales.{i}"
                           for i in range(n_scales)}

    def forward(self, x: Tensor):
        score, feats, h = 0.0, [], x
        for scale in self.scales:
            s, f = scale(h)
            score = score + s
            feats.extend(f)
            h = _halve(h)
        return [score[:, None, None]], [feats]


def _fold(x: Tensor, p: int, mode: str) -> Tensor:
    """(B, C, T) -> (B, C, ceil(T / p), p), the tail padded (``mode``
    'constant' zeros or 'reflect')."""
    pad = (p - x.shape[-1] % p) % p
    if pad:
        x = F.pad(x, (0, pad), mode=mode)
    return x.reshape(x.shape[0], x.shape[1], -1, p)


class MultiPeriodDiscriminator(Discriminator):
    """HiFi-GAN's period discriminator (reference: discriminators.py:
    145-180): time folded by each period (zero padded), ``n_layers``
    (5, 1) convs of stride (3, 1) with LeakyReLU 0.2, each a feature map,
    then a (3, 1) logit conv. Returns (logits, feature maps) by period."""

    def __init__(self, in_channels: int = 1,
                 periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 capacity: int = 32, n_layers: int = 4):
        super().__init__()
        self.periods = tuple(periods)
        chs = [in_channels] + [capacity * 2 ** i for i in range(n_layers)]
        self.convs = nn.ModuleList(nn.ModuleList(
            WNConv2d(a, b, (5, 1), stride=(3, 1))
            for a, b in zip(chs[:-1], chs[1:])) for _ in self.periods)
        self.outs = nn.ModuleList(WNConv2d(chs[-1], 1, (3, 1))
                                  for _ in self.periods)
        self.flax_names = {}
        for j, p in enumerate(self.periods):
            self.flax_names[f"p{p}_out"] = f"outs.{j}"
            for i in range(n_layers):
                self.flax_names[f"p{p}_conv_{i}"] = f"convs.{j}.{i}"

    def forward(self, x: Tensor):
        logits, fmaps = [], []
        for p, convs, out in zip(self.periods, self.convs, self.outs):
            h, feats = _fold(x, p, "constant"), []
            for conv in convs:
                h = F.leaky_relu(conv(h), 0.2)
                feats.append(h)
            logits.append(out(h))
            fmaps.append(feats)
        return logits, fmaps


class MPD(Discriminator):
    """DAC's period discriminator (reference: discriminators.py:312-350):
    time folded by ``period`` (reflect padded), (5, 1) convs of stride
    (3, 1) (the last (1, 1)) with LeakyReLU 0.1, then a (3, 1) logit
    conv; returns its feature maps, the logits last."""

    def __init__(self, period: int, in_channels: int = 1,
                 channels: Tuple[int, ...] = (32, 128, 512, 1024, 1024)):
        super().__init__()
        self.period = period
        chs = [in_channels] + list(channels)
        n = len(channels)
        self.convs = nn.ModuleList(
            WNConv2d(a, b, (5, 1), stride=(3, 1) if i < n - 1 else (1, 1),
                     padding=(2, 0))
            for i, (a, b) in enumerate(zip(chs[:-1], chs[1:])))
        self.conv_post = WNConv2d(chs[-1], 1, (3, 1), padding=(1, 0))
        self.flax_names = {f"conv_{i}": f"convs.{i}" for i in range(n)}

    def forward(self, x: Tensor) -> List[Tensor]:
        h, fmap = _fold(x, self.period, "reflect"), []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), 0.1)
            fmap.append(h)
        fmap.append(self.conv_post(h))
        return fmap


# (out channels, kernel, stride, groups) of MSD's convs
MSD_SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16),
             (1024, 41, 4, 64), (1024, 41, 4, 256), (1024, 5, 1, 1))


class MSD(Discriminator):
    """DAC's waveform discriminator (reference: discriminators.py:
    353-386): the signal's rate reduced by ``rate`` with average pooling
    (the JAX package's stand-in for the polyphase resample), grouped
    large-kernel convs (groups min(g, in channels)) with LeakyReLU 0.1,
    then a k=3 logit conv; returns its feature maps, the logits last."""

    def __init__(self, rate: int = 1, in_channels: int = 1):
        super().__init__()
        self.rate = rate
        convs, ch = [], in_channels
        for c, k, st, g in MSD_SPECS:
            convs.append(WNConv1d(ch, c, k, stride=st, padding=k // 2,
                                  groups=min(g, ch)))
            ch = c
        self.convs = nn.ModuleList(convs)
        self.conv_post = WNConv1d(ch, 1, 3, padding=1)
        self.flax_names = {f"conv_{i}": f"convs.{i}"
                           for i in range(len(MSD_SPECS))}

    def forward(self, x: Tensor) -> List[Tensor]:
        h = _halve(x, self.rate) if self.rate > 1 else x
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), 0.1)
            fmap.append(h)
        fmap.append(self.conv_post(h))
        return fmap


MRD_BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75),
             (0.75, 1.0))


class MRD(Discriminator):
    """DAC's complex multi-band spectrogram discriminator (reference:
    discriminators.py:392-470): ``ops.stft`` (center, Hann, hop
    window_length x hop_factor) of each channel, (real, imag) the conv
    channels, the bins split into ``bands`` at int(lo * n_bins); per
    band five convs ((3, 9), the middle three of stride (1, 2), the last
    (3, 3)) with LeakyReLU 0.1, each a feature map; the bands joined
    along frequency into a (3, 3) logit conv. Returns the feature maps,
    the logits last; their batch is B x C."""

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 bands: Tuple[Tuple[float, float], ...] = MRD_BANDS,
                 ch: int = 32):
        super().__init__()
        self.window_length, self.hop_factor = window_length, hop_factor
        self.bands = tuple(tuple(b) for b in bands)
        kernels = [(3, 9)] * 4 + [(3, 3)]
        self.band_convs = nn.ModuleList(nn.ModuleList(
            WNConv2d(2 if i == 0 else ch, ch, k,
                     stride=(1, 2) if i in (1, 2, 3) else (1, 1),
                     padding=(k[0] // 2, k[1] // 2))
            for i, k in enumerate(kernels)) for _ in self.bands)
        self.conv_post = WNConv2d(ch, 1, (3, 3), padding=(1, 1))
        self.flax_names = {f"band{bi}_conv_{i}": f"band_convs.{bi}.{i}"
                           for bi in range(len(self.bands))
                           for i in range(len(kernels))}

    def spectrogram_bands(self, x: Tensor) -> List[Tensor]:
        hop = int(self.window_length * self.hop_factor)
        spec = stft_fn(x.reshape(-1, x.shape[-1]), self.window_length, hop)
        spec = torch.stack([spec.real, spec.imag], dim=1).transpose(-1, -2)
        n_f = spec.shape[-1]
        return [spec[..., int(lo * n_f):int(hi * n_f)]
                for lo, hi in self.bands]

    def forward(self, x: Tensor) -> List[Tensor]:
        fmap, outs = [], []
        for convs, h in zip(self.band_convs, self.spectrogram_bands(x)):
            for conv in convs:
                h = F.leaky_relu(conv(h), 0.1)
                fmap.append(h)
            outs.append(h)
        fmap.append(self.conv_post(torch.cat(outs, dim=-1)))
        return fmap


def cqt_kernels(sample_rate: int, n_bins: int, bins_per_octave: int,
                fmin: float) -> np.ndarray:
    """The constant-Q filterbank (bins, n, 2) float32: per bin below 0.95 x
    Nyquist, a Hann-windowed complex exponential (cos, -sin) of length
    ceil(Q fs / f) divided by that length, n the next power of two of the
    longest (the JAX package's, built with ``np.hanning``)."""
    fs = sample_rate
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    freqs = freqs[freqs < fs / 2 * 0.95]
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lens = np.ceil(q * fs / freqs).astype(int)
    n = int(2 ** np.ceil(np.log2(lens.max())))
    kern = np.zeros((len(freqs), n, 2), np.float32)
    t = np.arange(n)
    for i, (f, length) in enumerate(zip(freqs, lens)):
        length = min(length, n)
        win = np.hanning(length)
        ph = 2 * np.pi * f / fs * t[:length]
        kern[i, :length, 0] = win * np.cos(ph) / length
        kern[i, :length, 1] = -win * np.sin(ph) / length
    return kern


class CQTDiscriminator(Discriminator):
    """A constant-Q discriminator (the BigVGAN-v2 CQT sub-band idea,
    reference: discriminators.py:472-550): frames of n samples every
    ``hop`` (indices past the end clamped, as JAX's gather), their
    response to the fixed ``cqt_kernels`` (one matmul), then four (3, 9)
    convs (the last three of stride (1, 2)) and a (3, 3) logit conv over
    (real / imag, frames, bins). Returns the feature maps, the logits
    last; their batch is B x C."""

    def __init__(self, sample_rate: int = 8000, n_bins: int = 48,
                 bins_per_octave: int = 12, fmin: float = 32.7,
                 hop: int = 256, ch: int = 32):
        super().__init__()
        self.hop = hop
        self.register_buffer("kernels", torch.from_numpy(cqt_kernels(
            sample_rate, n_bins, bins_per_octave, fmin)), persistent=False)
        self.convs = nn.ModuleList(
            WNConv2d(2 if i == 0 else ch, ch, (3, 9),
                     stride=(1, 2 if i else 1), padding=(1, 4))
            for i in range(4))
        self.conv_post = WNConv2d(ch, 1, (3, 3), padding=(1, 1))
        self.flax_names = {f"conv_{i}": f"convs.{i}" for i in range(4)}

    def forward(self, x: Tensor) -> List[Tensor]:
        xs = x.reshape(-1, x.shape[-1])
        n = self.kernels.shape[1]
        frames = max(1, (xs.shape[-1] - n) // self.hop + 1)
        idx = (torch.arange(frames, device=x.device)[:, None] * self.hop
               + torch.arange(n, device=x.device)[None])
        h = torch.einsum("btn,knc->bctk", xs[:, idx.clamp(
            max=xs.shape[-1] - 1)], self.kernels.to(x.dtype))
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), 0.1)
            fmap.append(h)
        fmap.append(self.conv_post(h))
        return fmap


def _peak_normalize(x: Tensor) -> Tensor:
    """DC removed, each (B, C) row scaled to a peak of 0.8 (eps 1e-9)."""
    x = x - x.mean(dim=-1, keepdim=True)
    return 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)


class DACDiscriminator(Discriminator):
    """DAC's combination of MPD (``periods``), MSD (``rates``) and MRD
    (``fft_sizes``) on the peak-normalized signal (reference:
    discriminators.py:553-596). Returns each sub-discriminator's feature
    maps, logits last."""

    def __init__(self, in_channels: int = 1,
                 periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 rates: Tuple[int, ...] = (),
                 fft_sizes: Tuple[int, ...] = (2048, 1024, 512),
                 bands: Tuple[Tuple[float, float], ...] = MRD_BANDS):
        super().__init__()
        self.mpds = nn.ModuleList(MPD(p, in_channels) for p in periods)
        self.msds = nn.ModuleList(MSD(r, in_channels) for r in rates)
        self.mrds = nn.ModuleList(MRD(f, bands=bands) for f in fft_sizes)
        self.flax_names = {
            **{f"mpd_{p}": f"mpds.{i}" for i, p in enumerate(periods)},
            **{f"msd_{r}": f"msds.{i}" for i, r in enumerate(rates)},
            **{f"mrd_{f}": f"mrds.{i}" for i, f in enumerate(fft_sizes)}}

    def forward(self, x: Tensor) -> List[List[Tensor]]:
        x = _peak_normalize(x)
        return [d(x) for d in (*self.mpds, *self.msds, *self.mrds)]


class BigVGANDiscriminator(Discriminator):
    """BigVGAN's MPD + CQT combination (reference: discriminators.py:
    663-687) on the peak-normalized signal."""

    def __init__(self, in_channels: int = 1, sample_rate: int = 8000,
                 periods: Tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.mpds = nn.ModuleList(MPD(p, in_channels) for p in periods)
        self.cqt = CQTDiscriminator(sample_rate=sample_rate)
        self.flax_names = {f"mpd_{p}": f"mpds.{i}"
                           for i, p in enumerate(periods)}

    def forward(self, x: Tensor) -> List[List[Tensor]]:
        x = _peak_normalize(x)
        return [d(x) for d in (*self.mpds, self.cqt)]


def least_squares_terms(score_real: Tensor, score_fake: Tensor
                        ) -> Tuple[Tensor, Tensor]:
    """DAC's least-squares discriminator loss's reals' and fakes' terms."""
    return ((1.0 - score_real) ** 2).mean(), (score_fake ** 2).mean()


def dac_gan_loss(disc: nn.Module, reals: Tensor, fakes: Tensor,
                 use_hinge: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """DACGANLoss (reference: discriminators.py:598-661): (dis_loss,
    gen_loss, feature distance) of a feature-map-list discriminator,
    averaged over its sub-discriminators. Least squares by default, hinge
    with ``use_hinge``; the feature distance is the L1 of every map but
    the logits, the real maps detached, averaged per sub-discriminator."""
    d_fake, d_real = disc(fakes), disc(reals)
    n = len(d_fake)
    dis_loss = gen_loss = feat = 0.0
    for fm_f, fm_r in zip(d_fake, d_real):
        lf, lr = fm_f[-1], fm_r[-1]
        if use_hinge:
            dis_loss = dis_loss + F.relu(lf).mean() + F.relu(1.0 - lr).mean()
            gen_loss = gen_loss + F.relu(1.0 - lf).mean()
        else:
            real, fake = least_squares_terms(lr, lf)
            dis_loss = dis_loss + fake + real
            gen_loss = gen_loss + ((1.0 - lf) ** 2).mean()
        feat = feat + sum((a - b.detach()).abs().mean() for a, b in zip(
            fm_f[:-1], fm_r[:-1])) / (len(fm_f) - 1)
    return dis_loss / n, gen_loss / n, feat / n


def create_discriminator_from_config(cfg, in_channels: int = 1,
                                     sample_rate: int = 8000
                                     ) -> Discriminator:
    """The ``loss_configs['discriminator']`` type dispatch (reference:
    training/autoencoders.py:150-157): 'encodec' | 'oobleck' | 'dac' |
    'big_vgan', the model's ``in_channels`` and ``sample_rate`` routed in
    (a config's ``channels`` is dropped). Encodec refuses ``win_lengths``
    other than its ``n_ffts`` (its window is always n_fft); BigVGAN drops
    the ``cqtd_*`` keys, as the JAX package does. Seeded by the caller
    (``reset_parameters``)."""
    kind = cfg["type"]
    c = {k: tuple(tuple(v) if isinstance(v, list) else v for v in val)
         if isinstance(val, list) else val
         for k, val in cfg.get("config", {}).items()}
    c.pop("channels", None)
    if kind == "encodec":
        win = c.pop("win_lengths", None)
        if win is not None and tuple(win) != tuple(c.get("n_ffts", win)):
            raise NotImplementedError(
                "encodec discriminator with win_lengths != n_ffts")
        return MultiScaleSTFTDiscriminator(in_channels=in_channels, **c)
    if kind == "oobleck":
        return OobleckDiscriminator(in_channels=in_channels, **c)
    if kind == "dac":
        return DACDiscriminator(in_channels=in_channels, **c)
    if kind == "big_vgan":
        c = {k: v for k, v in c.items() if not k.startswith("cqtd_")}
        return BigVGANDiscriminator(in_channels=in_channels,
                                    sample_rate=sample_rate, **c)
    raise ValueError(f"unknown discriminator type {kind!r}")


HINGE_FAMILIES = (MultiScaleSTFTDiscriminator, OobleckDiscriminator,
                  MultiPeriodDiscriminator)
LEAST_SQUARES_FAMILIES = (DACDiscriminator, BigVGANDiscriminator)


def discriminator_loss(disc: nn.Module, reals: Tensor, fakes: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dis_loss, adv_loss, feature_matching) of any family: DAC and
    BigVGAN through ``dac_gan_loss`` (least squares), the (logits,
    feature maps) families through the hinge losses."""
    if isinstance(disc, LEAST_SQUARES_FAMILIES):
        return dac_gan_loss(disc, reals, fakes)
    if isinstance(disc, HINGE_FAMILIES):
        return encodec_discriminator_loss(disc, reals, fakes)
    raise _no_family(disc)


def discriminator_loss_terms(disc: nn.Module, reals: Tensor, fakes: Tensor
                             ) -> Tuple[Tensor, Tensor]:
    """``discriminator_loss``'s dis_loss split into its reals' term and its
    fakes' term, each averaged over the sub-discriminators (their sum is
    the loss, up to rounding): DAC's and BigVGAN's least-squares terms,
    the other families' hinge terms."""
    if isinstance(disc, LEAST_SQUARES_FAMILIES):
        pairs = [(r[-1], f[-1]) for r, f in zip(disc(reals), disc(fakes))]
        terms = least_squares_terms
    elif isinstance(disc, HINGE_FAMILIES):
        pairs = list(zip(disc(reals)[0], disc(fakes)[0]))
        terms = hinge_terms
    else:
        raise _no_family(disc)
    real, fake = zip(*(terms(r, f) for r, f in pairs))
    return sum(real) / len(pairs), sum(fake) / len(pairs)


def _no_family(disc: nn.Module) -> TypeError:
    return TypeError(
        f"{type(disc).__name__} is no discriminator family of "
        "discriminator_loss (Encodec, Oobleck, the period discriminator, "
        "DAC, BigVGAN)")
