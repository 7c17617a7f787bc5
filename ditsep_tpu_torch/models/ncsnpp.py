"""NCSN++ 2-D U-Net score network (PyTorch, logical NCHW).

Port of ditsep_tpu/models/ncsnpp.py. Submodules live in ``all_modules``
(an ``nn.ModuleList``) in the exact construction order of the reference's
index walk, so parameter names are the reference torch names
(``all_modules.{i}.Conv_0.weight``, ...). The attention placement uses the
static resolution schedule ``image_size // 2**level``, as the JAX package
does.

Every configuration of the JAX module: BigGAN or DDPM residual blocks
(DDPM levels joined by ``Downsample`` / ``Upsample``: FIR, or average
pooling / nearest without ``fir``, each with a 3x3 conv under
``resamp_with_conv``), ``progressive`` in (none, output_skip, residual),
``progressive_input`` in (none, input_skip, residual),
``progressive_combine`` in (sum, cat). The non-Fourier embedding raises,
as the JAX module asserts (ditsep_tpu/models/ncsnpp.py:72-74).

``fir_down2d`` (``ops.fir.downsample_2d`` on the card) runs wherever FIR
downsampling without a conv does: a BigGAN down block's two (h and the
skip), a DDPM ``Downsample(fir=True, with_conv=False)`` between levels,
and the input_skip pyramid's.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ditsep_tpu_torch.models import layers as L

Tensor = torch.Tensor


class NCSNpp(nn.Module):
    """NCSN++ U-Net. Constructor arguments mirror the JAX module's fields."""

    def __init__(
        self,
        scale_by_sigma: bool = True,
        nonlinearity: str = "swish",
        nf: int = 128,
        ch_mult: Sequence[int] = (1, 2, 1, 1, 1),
        num_res_blocks: int = 2,
        attn_resolutions: Sequence[int] = (4, 8, 16),
        resamp_with_conv: bool = True,
        conditional: bool = True,
        fir: bool = True,
        fir_kernel: Sequence[float] = (1, 3, 3, 1),
        skip_rescale: bool = True,
        resblock_type: str = "biggan",
        progressive: str = "output_skip",
        progressive_input: str = "input_skip",
        progressive_combine: str = "sum",
        init_scale: float = 0.0,
        fourier_scale: float = 16.0,
        image_size: int = 64,
        num_channels_in: int = 4,
        num_channels_out: int = 4,
        embedding_type: str = "fourier",
        dropout: float = 0.0,
        centered: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if resblock_type not in ("biggan", "ddpm"):
            raise ValueError(f"resblock type {resblock_type} unrecognized.")
        if progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"progressive={progressive!r}")
        if progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"progressive_input={progressive_input!r}")
        if embedding_type != "fourier":
            raise NotImplementedError(
                f"embedding_type={embedding_type!r}: only the fourier "
                "embedding, as the JAX package asserts "
                "(ditsep_tpu/models/ncsnpp.py:72-74)")
        combine_method = progressive_combine.lower()
        self.act = act = L.get_act(nonlinearity)
        self.scale_by_sigma = scale_by_sigma
        self.conditional = conditional
        self.centered = centered
        self.num_res_blocks = num_res_blocks
        self.resblock_type = resblock_type
        self.progressive = progressive
        self.progressive_input = progressive_input
        self.skip_rescale = skip_rescale
        self.attn_resolutions = tuple(attn_resolutions)
        ch_mult = tuple(ch_mult)
        self.num_resolutions = num_resolutions = len(ch_mult)
        self.all_resolutions = [image_size // (2 ** i)
                                for i in range(num_resolutions)]
        temb_dim = nf * 4 if conditional else None
        fir_kernel = tuple(fir_kernel)

        def ResnetBlock(in_ch, out_ch=None, up=False, down=False):
            if resblock_type == "ddpm":
                return L.ResnetBlockDDPMpp(
                    act=act, in_ch=in_ch, out_ch=out_ch, temb_dim=temb_dim,
                    dropout=dropout, skip_rescale=skip_rescale,
                    init_scale=init_scale, dtype=dtype)
            return L.ResnetBlockBigGANpp(
                act=act, in_ch=in_ch, out_ch=out_ch, temb_dim=temb_dim,
                up=up, down=down, dropout=dropout, fir=fir,
                fir_kernel=fir_kernel, skip_rescale=skip_rescale,
                init_scale=init_scale, dtype=dtype)

        def AttnBlock(ch):
            return L.AttnBlockpp(ch, skip_rescale=skip_rescale,
                                 init_scale=init_scale, dtype=dtype)

        modules = []
        # -- time embedding -------------------------------------------------
        modules.append(L.GaussianFourierProjection(nf, fourier_scale))
        if conditional:
            modules.append(L.Linear(2 * nf, nf * 4, dtype=dtype))
            modules.append(L.Linear(nf * 4, nf * 4, dtype=dtype))

        channels = num_channels_in
        # -- down path ------------------------------------------------------
        modules.append(L.conv3x3(channels, nf, dtype=dtype))
        hs_c = [nf]
        in_ch = nf
        pyramid_in_ch = channels  # the input pyramid's width ('residual')
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                modules.append(ResnetBlock(in_ch, out_ch))
                in_ch = out_ch
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    modules.append(AttnBlock(in_ch))
                hs_c.append(in_ch)
            if i_level != num_resolutions - 1:
                if resblock_type == "ddpm":
                    modules.append(L.Downsample(
                        in_ch, with_conv=resamp_with_conv, fir=fir,
                        fir_kernel=fir_kernel, dtype=dtype))
                else:
                    modules.append(ResnetBlock(in_ch, down=True))
                if progressive_input == "input_skip":
                    modules.append(L.Combine(channels, in_ch,
                                             method=combine_method,
                                             dtype=dtype))
                    if combine_method == "cat":
                        in_ch *= 2
                elif progressive_input == "residual":
                    modules.append(L.Downsample(
                        pyramid_in_ch, out_ch=in_ch, with_conv=True, fir=fir,
                        fir_kernel=fir_kernel, dtype=dtype))
                    pyramid_in_ch = in_ch
                hs_c.append(in_ch)

        # -- middle ---------------------------------------------------------
        modules.append(ResnetBlock(in_ch))
        modules.append(AttnBlock(in_ch))
        modules.append(ResnetBlock(in_ch))

        # -- up path --------------------------------------------------------
        pyramid_ch = 0
        for i_level in reversed(range(num_resolutions)):
            for _ in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                modules.append(ResnetBlock(in_ch + hs_c.pop(), out_ch))
                in_ch = out_ch
            if self.all_resolutions[i_level] in self.attn_resolutions:
                modules.append(AttnBlock(in_ch))
            if progressive != "none":
                if i_level == num_resolutions - 1:
                    modules.append(L.group_norm(in_ch, dtype=dtype))
                    pyr_out = channels if progressive == "output_skip" \
                        else in_ch
                    modules.append(L.conv3x3(
                        in_ch, pyr_out, dtype=dtype,
                        init_scale=(init_scale if progressive ==
                                    "output_skip" else 1.0)))
                    pyramid_ch = pyr_out
                elif progressive == "output_skip":
                    modules.append(L.group_norm(in_ch, dtype=dtype))
                    modules.append(L.conv3x3(in_ch, channels,
                                             init_scale=init_scale,
                                             dtype=dtype))
                    pyramid_ch = channels
                else:  # residual
                    modules.append(L.Upsample(
                        pyramid_ch, out_ch=in_ch, with_conv=True, fir=fir,
                        fir_kernel=fir_kernel, dtype=dtype))
                    pyramid_ch = in_ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    modules.append(L.Upsample(
                        in_ch, with_conv=resamp_with_conv, fir=fir,
                        fir_kernel=fir_kernel, dtype=dtype))
                else:
                    modules.append(ResnetBlock(in_ch, up=True))
        assert not hs_c

        if progressive != "output_skip":
            modules.append(L.group_norm(in_ch, dtype=dtype))
            modules.append(L.conv3x3(in_ch, channels, init_scale=init_scale,
                                     dtype=dtype))
        self.all_modules = nn.ModuleList(modules)

        # parameter-free pyramid resamplers
        self.pyramid_upsample = L.Upsample(fir=fir, fir_kernel=fir_kernel)
        self.pyramid_downsample = L.Downsample(fir=fir, fir_kernel=fir_kernel)

        # final 1x1 projection, outside all_modules (flax nn.Conv default
        # init: lecun normal, zero bias)
        self.output_layer = L.Conv2d(channels, num_channels_out, 1,
                                     dtype=dtype)
        self.fir = fir
        self.resamp_with_conv = resamp_with_conv
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """(Re)initialise every parameter from ``generator``, in module
        order, with the JAX package's initialisers."""
        for m in self.all_modules.modules():
            if m is not self.all_modules and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        w = self.output_layer.weight
        std = math.sqrt(1.0 / w.shape[1]) / .87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(self.output_layer.bias)

    def _skip(self, a: Tensor, b: Tensor) -> Tensor:
        """A residual pyramid's sum, over sqrt(2) with ``skip_rescale``."""
        return (a + b) / math.sqrt(2.0) if self.skip_rescale else a + b

    def forward(self, x: Tensor, time_cond: Tensor, *,
                time_mask: Optional[Tensor] = None) -> Tensor:
        """x (B, C_in, H, W); time_cond (B,) -> (B, C_out, H, W).

        ``time_mask`` (B, W) bool marks the valid time columns: every
        GroupNorm then takes its statistics over valid columns only and
        attention gives no weight to keys in invalid ones, with one mask
        per level pooled from the one above (masked scoring; None is the
        reference semantics)."""
        modules = self.all_modules
        m_idx = 0
        if time_mask is None:
            masks = [None] * self.num_resolutions
        else:
            masks = [time_mask.bool()]
            for _ in range(self.num_resolutions - 1):
                masks.append(L.pool_time_mask(masks[-1]))

        used_sigmas = time_cond
        temb = modules[m_idx](torch.log(used_sigmas))
        m_idx += 1
        if self.conditional:
            temb = modules[m_idx](temb)
            m_idx += 1
            temb = modules[m_idx](self.act(temb))
            m_idx += 1
        else:
            temb = None

        if not self.centered:
            x = 2.0 * x - 1.0

        input_pyramid = x if self.progressive_input != "none" else None

        hs = [modules[m_idx](x)]
        m_idx += 1

        # -- down path ------------------------------------------------------
        for i_level in range(self.num_resolutions):
            for _ in range(self.num_res_blocks):
                h = modules[m_idx](hs[-1], temb, tmask=masks[i_level])
                m_idx += 1
                if self.all_resolutions[i_level] in self.attn_resolutions:
                    h = modules[m_idx](h, tmask=masks[i_level])
                    m_idx += 1
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                if self.resblock_type == "ddpm":
                    h = modules[m_idx](hs[-1])
                else:
                    h = modules[m_idx](hs[-1], temb, tmask=masks[i_level],
                                       tmask_out=masks[i_level + 1])
                m_idx += 1
                if self.progressive_input == "input_skip":
                    input_pyramid = self.pyramid_downsample(input_pyramid)
                    h = modules[m_idx](input_pyramid, h)
                    m_idx += 1
                elif self.progressive_input == "residual":
                    input_pyramid = self._skip(modules[m_idx](input_pyramid),
                                               h)
                    m_idx += 1
                    h = input_pyramid
                hs.append(h)

        # -- middle ---------------------------------------------------------
        h = hs[-1]
        h = modules[m_idx](h, temb, tmask=masks[-1])
        m_idx += 1
        h = modules[m_idx](h, tmask=masks[-1])
        m_idx += 1
        h = modules[m_idx](h, temb, tmask=masks[-1])
        m_idx += 1

        pyramid = None
        # -- up path --------------------------------------------------------
        for i_level in reversed(range(self.num_resolutions)):
            for _ in range(self.num_res_blocks + 1):
                h = modules[m_idx](torch.cat([h, hs.pop()], dim=1), temb,
                                   tmask=masks[i_level])
                m_idx += 1
            if self.all_resolutions[i_level] in self.attn_resolutions:
                h = modules[m_idx](h, tmask=masks[i_level])
                m_idx += 1
            if self.progressive != "none":
                gm = L.time_mask_to_gn(masks[i_level])
                if i_level == self.num_resolutions - 1:
                    pyramid = self.act(modules[m_idx](h, gm))
                    m_idx += 1
                    pyramid = modules[m_idx](pyramid)
                    m_idx += 1
                elif self.progressive == "output_skip":
                    pyramid_h = self.act(modules[m_idx](h, gm))
                    m_idx += 1
                    pyramid_h = modules[m_idx](pyramid_h)
                    m_idx += 1
                    pyramid = self.pyramid_upsample(pyramid) + pyramid_h
                else:  # residual
                    pyramid = self._skip(modules[m_idx](pyramid), h)
                    m_idx += 1
                    h = pyramid
            if i_level != 0:
                if self.resblock_type == "ddpm":
                    h = modules[m_idx](h)
                else:
                    h = modules[m_idx](h, temb, tmask=masks[i_level],
                                       tmask_out=masks[i_level - 1])
                m_idx += 1
        assert not hs

        if self.progressive == "output_skip":
            h = pyramid
        else:
            h = self.act(modules[m_idx](h, L.time_mask_to_gn(masks[0])))
            m_idx += 1
            h = modules[m_idx](h)
            m_idx += 1

        assert m_idx == len(modules), "implementation error"
        if self.scale_by_sigma:
            h = h / used_sigmas.reshape((-1, 1, 1, 1))
        return self.output_layer(h)
