"""VAE-GAN training of the OobleckVAE (port of ditsep_tpu/training/
autoencoder.py; reference: stable-audio-tools training/autoencoders.py:
31-671).

The generator loss is the perceptually weighted MRSTFT (+ L1) of the
posterior-sample round trip, the KL, the teacher distillation's four terms
when a teacher is given, and, once warmed up, the adversarial and
feature-matching terms; the discriminator trains on odd steps
(``use_disc_this_step``), as the reference's ``global_step % 2`` gate.
With ``encoder_freeze_on_warmup`` the encoder takes no gradient once
warmed up; its parameters still take the optimizer's update (its decay
and momentum), as the JAX package's stop-gradient leaves them.

Every draw is explicit: from ``generator`` (a ``torch.Generator`` on the
batch's device), or from ``draws`` by role, in the port's layouts:

* ``enc_z`` (B, D, Tl) standard normals of the posterior sample (the JAX
  code draws them in (B, Tl, D));
* ``mask_u`` (B, D, Tl) uniforms of the latent mask (``latent_mask_ratio``
  > 0: an entry is zeroed where its uniform is below the ratio);
* ``teacher_z`` (B, D, Tl) normals of the teacher's posterior sample (the
  JAX code's ``fold_in(key, 7)``).

The default optimizers are AdamW(b1 0.8, b2 0.99, wd 1e-3) under the
inverse-LR schedule (``ClipAdamW``). ``vae_tx`` / ``disc_tx``, optimizers
read from a config's ``optimizer_configs`` (``schedules.
create_optimizer_from_config``), replace them. The VAE's clips only with
``clip_grad_norm`` > 0 (a config's optimizer too, the clip first), the
discriminator's never. The discriminator is any family of
``models/discriminators.py``, through ``discriminator_loss``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.models.discriminators import discriminator_loss
from ditsep_tpu_torch.models.oobleck import OobleckVAE, vae_sample
from ditsep_tpu_torch.training import auraloss
from ditsep_tpu_torch.training.diffsep import Draws, _draw, ema_update_
from ditsep_tpu_torch.training.schedules import (
    ClipAdamW, OptimizerSpec, ScheduledOptimizer,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AutoencoderLossConfig:
    """(reference: oobleck_finetune.json 'training.loss_configs')."""

    mrstft: float = 1.0
    l1: float = 0.0
    kl: float = 1e-4
    adversarial: float = 0.1
    feature_matching: float = 5.0
    fft_sizes: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64, 32)
    hop_sizes: Tuple[int, ...] = (512, 256, 128, 64, 32, 16, 8)
    perceptual_weighting: bool = True
    sample_rate: int = 8000


@dataclasses.dataclass
class AutoencoderState:
    """``step`` (generator and discriminator steps), the live ``vae`` and
    ``disc``, their optimizers and ``ema_vae``, a copy of the VAE holding
    its EMA."""

    step: int
    vae: nn.Module
    vae_optimizer: ScheduledOptimizer
    ema_vae: nn.Module
    disc: Optional[nn.Module] = None
    disc_optimizer: Optional[ScheduledOptimizer] = None

    def state_dict(self) -> dict:
        out = {"step": self.step, "vae": self.vae.state_dict(),
               "vae_optimizer": self.vae_optimizer.state_dict(),
               "ema_vae": self.ema_vae.state_dict()}
        if self.disc is not None:
            out["disc"] = self.disc.state_dict()
            out["disc_optimizer"] = self.disc_optimizer.state_dict()
        return out

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.vae.load_state_dict(state["vae"])
        self.vae_optimizer.load_state_dict(state["vae_optimizer"])
        self.ema_vae.load_state_dict(state["ema_vae"])
        if self.disc is not None:
            self.disc.load_state_dict(state["disc"])
            self.disc_optimizer.load_state_dict(state["disc_optimizer"])


@dataclasses.dataclass(frozen=True)
class AutoencoderTrainer:
    """``vae`` and ``disc`` (any ported discriminator family) on one
    device; ``teacher_vae`` a frozen VAE with its own weights for the
    distillation terms."""

    vae: OobleckVAE
    disc: Optional[nn.Module] = None
    loss_cfg: AutoencoderLossConfig = AutoencoderLossConfig()
    lr: float = 1.5e-4
    disc_lr: float = 3e-4
    warmup_steps: int = 0
    encoder_freeze_on_warmup: bool = False
    ema_decay: float = 0.9999
    clip_grad_norm: float = 0.0
    latent_mask_ratio: float = 0.0
    teacher_vae: Optional[OobleckVAE] = None
    vae_tx: Optional[OptimizerSpec] = None
    disc_tx: Optional[OptimizerSpec] = None

    def make_vae_optimizer(self, params) -> ScheduledOptimizer:
        if self.vae_tx is not None:
            return self.vae_tx.build(params, clip=self.clip_grad_norm)
        return ClipAdamW(params, self.lr, clip=self.clip_grad_norm)

    def make_disc_optimizer(self, params) -> ScheduledOptimizer:
        if self.disc_tx is not None:
            return self.disc_tx.build(params)
        return ClipAdamW(params, self.disc_lr)

    def init_state(self) -> AutoencoderState:
        """A fresh state: the VAE and the discriminator trainable, the
        teacher frozen, the EMA a copy of the VAE."""
        vae = self.vae.requires_grad_(True)
        if self.teacher_vae is not None:
            self.teacher_vae.requires_grad_(False)
        state = AutoencoderState(
            step=0, vae=vae,
            vae_optimizer=self.make_vae_optimizer(vae.parameters()),
            ema_vae=copy.deepcopy(vae).requires_grad_(False))
        if self.disc is not None:
            state.disc = self.disc.requires_grad_(True)
            state.disc_optimizer = self.make_disc_optimizer(
                self.disc.parameters())
        return state

    def _mrstft(self, a: Tensor, b: Tensor) -> Tensor:
        cfg = self.loss_cfg
        t = min(a.shape[-1], b.shape[-1])
        return auraloss.multi_resolution_stft_loss(
            a[..., :t], b[..., :t], fft_sizes=cfg.fft_sizes,
            hop_sizes=cfg.hop_sizes, sample_rate=cfg.sample_rate,
            perceptual_weighting=cfg.perceptual_weighting)

    def _roundtrip(self, reals: Tensor, generator, draws: Draws,
                   freeze_encoder: bool = False):
        """encode (a posterior sample) -> [latent mask] -> decode; returns
        (decoded, reals, both cropped to the shorter, kl, latents)
        (reference: autoencoders.py:410-415)."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not freeze_encoder):
            mean, scale = self.vae.moments(reals)
            z = _draw(draws, "enc_z", mean.shape, "normal", generator,
                      mean.device)
            lat, kl = vae_sample(mean, scale, z)
        dec_in = lat
        if self.latent_mask_ratio > 0.0:
            u = _draw(draws, "mask_u", lat.shape, "uniform", generator,
                      lat.device)
            dec_in = torch.where(u < self.latent_mask_ratio,
                                 torch.zeros_like(lat), lat)
        decoded = self.vae.decode(dec_in)
        t = min(decoded.shape[-1], reals.shape[-1])
        return decoded[..., :t], reals[..., :t], kl, lat

    def gen_loss(self, reals: Tensor, warmed_up: bool, *, generator=None,
                 draws: Draws = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """(total, the weighted terms) (reference: autoencoders.py:
        162-250, 420-470)."""
        cfg = self.loss_cfg
        freeze = warmed_up and self.encoder_freeze_on_warmup
        decoded, reals_t, kl, lat = self._roundtrip(
            reals, generator, draws, freeze_encoder=freeze)
        losses: Dict[str, Tensor] = {"mrstft": cfg.mrstft
                                     * self._mrstft(decoded, reals_t)}
        if cfg.l1 > 0:
            losses["l1"] = cfg.l1 * auraloss.l1_loss(decoded, reals_t)
        losses["kl"] = cfg.kl * kl
        if self.teacher_vae is not None:
            # distillation (reference: autoencoders.py:171-179, 404-409):
            # the teacher encodes a posterior sample, not the mode
            teacher = self.teacher_vae
            with torch.no_grad():
                mean, scale = teacher.moments(reals)
                z = _draw(draws, "teacher_z", mean.shape, "normal",
                          generator, mean.device)
                t_lat = vae_sample(mean, scale, z)[0]
                t_dec = teacher.decode(t_lat)
            own_lat_t_dec = teacher.decode(lat)
            t_lat_own_dec = self.vae.decode(t_lat)
            w = cfg.mrstft
            losses["latent_distill"] = w * ((t_lat - lat) ** 2).mean()
            losses["mrstft_distill"] = w * self._mrstft(decoded, t_dec)
            losses["mrstft_own_latents_teacher"] = w * self._mrstft(
                own_lat_t_dec, reals_t)
            losses["mrstft_teacher_latents_own"] = w * self._mrstft(
                t_lat_own_dec, reals_t)
        if self.disc is not None and warmed_up:
            _, adv, fm = discriminator_loss(self.disc, reals_t, decoded)
            losses["adversarial"] = cfg.adversarial * adv
            losses["feature_matching"] = cfg.feature_matching * fm
        return sum(losses.values()), losses

    def gen_step(self, state: AutoencoderState, reals: Tensor,
                 warmed_up: bool = True, *, generator=None,
                 draws: Draws = None, mesh=None
                 ) -> Tuple[AutoencoderState, Dict]:
        """One VAE update and its EMA; a parameter without a gradient (the
        frozen encoder's) takes a zero one. With ``mesh``, ``reals`` is
        this rank's rows and the step the global batch's (the draws the
        global batch's, the gradient averaged over the ranks before the
        clip, the metrics averaged)."""
        params = list(state.vae.parameters())
        with torch.enable_grad(), parallel.sharded(mesh):
            loss, aux = self.gen_loss(reals, warmed_up, generator=generator,
                                      draws=draws)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        parallel.all_reduce_grads_(grads, mesh)
        state.vae_optimizer.step(grads)
        ema_update_(state.ema_vae, state.vae, self.ema_decay)
        state.step += 1
        metrics = {"train/loss": loss.detach(), **{
            f"train/{k}": v.detach() for k, v in aux.items()}}
        return state, parallel.all_reduce_metrics(metrics, mesh)

    def disc_step(self, state: AutoencoderState, reals: Tensor, *,
                  generator=None, draws: Draws = None, mesh=None
                  ) -> Tuple[AutoencoderState, Dict]:
        """One discriminator update on a round trip of the current VAE;
        ``mesh`` as ``gen_step``'s."""
        with torch.no_grad(), parallel.sharded(mesh):
            decoded, reals_t, _, _ = self._roundtrip(reals, generator, draws)
        params = list(state.disc.parameters())
        with torch.enable_grad(), parallel.sharded(mesh):
            loss, _, _ = discriminator_loss(state.disc, reals_t, decoded)
            grads = list(torch.autograd.grad(loss, params))
        parallel.all_reduce_grads_(grads, mesh)
        state.disc_optimizer.step(grads)
        state.step += 1
        return state, parallel.all_reduce_metrics(
            {"train/discriminator_loss": loss.detach()}, mesh)

    def use_disc_this_step(self, step: int) -> bool:
        if self.disc is None:
            return False
        return bool(step % 2) and step >= self.warmup_steps
