"""The Encodec multi-scale complex-STFT discriminator and its hinge and
feature-matching losses, for the VAE-GAN trainer and the LDM decoder
finetune (port of ditsep_tpu/models/discriminators.py:24-148, 478-502 and
543-550; reference: stable-audio-tools models/discriminators.py:15-62 and
models/encodec.py:38-151).

Layout: NCHW over (B, 2C, frames, bins). The JAX package runs NHWC with
H = time and W = frequency, so here H is the frame axis too: the (3, 9)
kernel spans 3 frames by 9 bins, the (1, 2) stride halves the bins and
the (d, 1) dilation dilates time. The STFT's channels stack as
``[real_0, ..., real_{C-1}, imag_0, ..., imag_{C-1}]``.

Weight normalization is an explicit (g, v) pair, ``w = v / sqrt(sum(v^2)
+ 1e-12) * g`` with the sum over all axes but the output channel, in the
reference's torch layouts: ``weight_v`` (out, in, kh, kw), ``weight_g``
(out, 1, 1, 1). ``models/weights.py:disc_params_{from,to}_jax`` carry
the JAX package's tree (``disc_{i}/conv_{j}/{v,g,bias}``) across.

The other discriminator families (Oobleck, MPD, MSD, MRD, CQT, DAC,
BigVGAN) belong to the stable-audio factory (ROADMAP A16).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ditsep_tpu_torch import parallel
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


class MultiScaleSTFTDiscriminator(nn.Module):
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

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """(Re)initialise every conv from ``generator``, in module order."""
        for m in self.modules():
            if isinstance(m, WNConv2d):
                m.reset_parameters(generator)

    def forward(self, x: Tensor) -> Tuple[List[Tensor], List[List[Tensor]]]:
        logits, fmaps = [], []
        for disc in self.discs:
            lg, fm = disc(x)
            logits.append(lg)
            fmaps.append(fm)
        return logits, fmaps


def hinge_losses(score_real: Tensor, score_fake: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """(discriminator loss, generator loss) of the hinge GAN."""
    gen_loss = -score_fake.mean()
    dis_loss = (F.relu(1.0 - score_real).mean()
                + F.relu(1.0 + score_fake).mean())
    return dis_loss, gen_loss


def encodec_discriminator_loss(disc: MultiScaleSTFTDiscriminator,
                               reals: Tensor, fakes: Tensor,
                               normalize_losses: bool = False
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Hinge adversarial and feature-matching losses averaged over the
    scales: (dis_loss, adv_loss, feature_matching_distance). The feature
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


def discriminator_loss(disc: nn.Module, reals: Tensor, fakes: Tensor
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dis_loss, adv_loss, feature_matching) of any ported family: the
    Encodec discriminator's hinge losses."""
    if isinstance(disc, MultiScaleSTFTDiscriminator):
        return encodec_discriminator_loss(disc, reals, fakes)
    raise NotImplementedError(
        f"discriminator {type(disc).__name__} is not ported yet (ROADMAP "
        "A16: the other families and dac_gan_loss)")
