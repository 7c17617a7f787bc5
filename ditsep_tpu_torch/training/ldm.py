"""The LDM decoder finetune: train the OobleckVAE's decoder on separated
latents against the clean sources (port of ditsep_tpu/training/ldm.py;
reference: src/ldm.py:42-731).

Only the decoder trains, with the Encodec discriminator when one is given:
``init_state`` makes ``vae.decoder``'s parameters the only trainable ones
of the latent trainer (its encoder and score model stay frozen, as the
JAX package's tree split holds them), and the generator and discriminator
updates are two steps the caller alternates by ``use_disc_this_step``.

* The generator: PIT-MRSTFT (+ PIT L1 / L2) on the decoded latents, plus,
  once warmed up and with a discriminator, the hinge adversarial and
  feature-matching losses; ``clip_by_global_norm(clip)`` then AdamW(b1
  0.8, b2 0.99, wd 1e-3) under the inverse-LR schedule at ``lr``; the
  decoder's EMA (0.9999) moves on these steps only.
* The discriminator: its hinge loss on the clean sources against the
  current decoder's output (no gradient into the decoder), the same
  optimizer at ``2 lr``.

``state.step`` counts both kinds of step; each optimizer's schedule
counts its own updates. The generator step takes its gradient with
``torch.autograd.grad`` over the decoder's parameters alone, so the
backward through the discriminator leaves nothing on the
discriminator's parameters.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.models.discriminators import (
    MultiScaleSTFTDiscriminator, encodec_discriminator_loss,
)
from ditsep_tpu_torch.training import auraloss
from ditsep_tpu_torch.training.diffsep import ema_update_
from ditsep_tpu_torch.training.diffsep_latent import LatentDiffSepTrainer
from ditsep_tpu_torch.training.schedules import ClipAdamW

Tensor = torch.Tensor


def _population_std(x: Tensor) -> Tensor:
    """The population std of ``x``; in a rank's shard, of the global
    batch (from the ranks' means of x and x^2)."""
    x = x.detach()
    shard = parallel.couples_batch("decoded_std")
    if shard is None:
        return x.std(correction=0)
    m = parallel.all_reduce_mean_(torch.stack([x.mean(), (x * x).mean()]),
                                  shard.mesh)
    return torch.sqrt(torch.clamp(m[1] - m[0] ** 2, min=0.0))


@dataclasses.dataclass(frozen=True)
class LDMLossWeights:
    """Loss weights and the MRSTFT config (oobleck_finetune.json's
    'spectral'; reference: src/config/ldm/training/default.yaml)."""

    mrstft: float = 1.0
    l1: float = 0.0
    l2: float = 0.0
    adversarial: float = 0.1
    feature_matching: float = 5.0
    fft_sizes: Tuple[int, ...] = (2048, 1024, 512, 256, 128, 64, 32)
    hop_sizes: Tuple[int, ...] = (512, 256, 128, 64, 32, 16, 8)
    perceptual_weighting: bool = True
    sample_rate: int = 8000


@dataclasses.dataclass
class LDMState:
    """``step`` (generator and discriminator steps), the live ``decoder``
    and ``disc`` modules (their parameters updated in place), their
    optimizers, and ``ema_decoder``, a copy of the decoder holding its
    EMA. ``media_failures`` counts the demo decodes that failed in the
    ``cli.train_ldm`` run that returned the state (not saved)."""

    step: int
    decoder: nn.Module
    gen_optimizer: ClipAdamW
    ema_decoder: nn.Module
    disc: Optional[nn.Module] = None
    disc_optimizer: Optional[ClipAdamW] = None
    media_failures: int = 0

    def state_dict(self) -> dict:
        out = {"step": self.step, "decoder": self.decoder.state_dict(),
               "gen_optimizer": self.gen_optimizer.state_dict(),
               "ema_decoder": self.ema_decoder.state_dict()}
        if self.disc is not None:
            out["disc"] = self.disc.state_dict()
            out["disc_optimizer"] = self.disc_optimizer.state_dict()
        return out

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.decoder.load_state_dict(state["decoder"])
        self.gen_optimizer.load_state_dict(state["gen_optimizer"])
        self.ema_decoder.load_state_dict(state["ema_decoder"])
        if self.disc is not None:
            self.disc.load_state_dict(state["disc"])
            self.disc_optimizer.load_state_dict(state["disc_optimizer"])


@dataclasses.dataclass(frozen=True)
class LDMTrainer:
    """``latent_trainer`` holds the VAE (and the frozen score model);
    ``disc`` the Encodec discriminator on the latent trainer's device
    (None trains without the GAN terms, as the shipped ldm config does)."""

    latent_trainer: LatentDiffSepTrainer
    disc: Optional[MultiScaleSTFTDiscriminator] = None
    weights: LDMLossWeights = LDMLossWeights()
    lr: float = 1.5e-4
    clip_grad_norm: float = 1.0
    ema_decay: float = 0.9999
    warmup_steps: int = 0
    warmup_mode: str = "full"  # 'full' | 'adv'

    @property
    def vae(self) -> nn.Module:
        return self.latent_trainer.vae

    def init_state(self) -> LDMState:
        """A fresh state: the decoder trainable and nothing else of the
        latent trainer, the discriminator trainable, the EMA a copy of the
        decoder."""
        self.latent_trainer.model.requires_grad_(False)
        self.vae.requires_grad_(False)
        decoder = self.vae.decoder.requires_grad_(True)
        state = LDMState(
            step=0, decoder=decoder,
            gen_optimizer=ClipAdamW(decoder.parameters(), self.lr,
                                    clip=self.clip_grad_norm),
            ema_decoder=copy.deepcopy(decoder).requires_grad_(False))
        if self.disc is not None:
            state.disc = self.disc.requires_grad_(True)
            state.disc_optimizer = ClipAdamW(self.disc.parameters(),
                                             2.0 * self.lr,
                                             clip=self.clip_grad_norm)
        return state

    def gen_loss(self, latents: Tensor, reals: Tensor, warmed_up: bool
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """PIT-MRSTFT + PIT L1 / L2 + adversarial + feature matching
        (reference: src/ldm.py:100-161, 476-484). Returns (total, the
        weighted terms and ``decoded_std``, the population std)."""
        w = self.weights
        # the live decoder, with gradients (reference: src/ldm.py:208-215)
        decoded = self.latent_trainer.decode_grad(latents, reals.shape[-1])
        losses: Dict[str, Tensor] = {}
        losses["pit_mrstft_loss"] = w.mrstft * auraloss.pit_min(
            lambda e, r: auraloss.multi_resolution_stft_loss(
                e, r, fft_sizes=w.fft_sizes, hop_sizes=w.hop_sizes,
                sample_rate=w.sample_rate,
                perceptual_weighting=w.perceptual_weighting),
            decoded, reals)
        if w.l1 > 0:
            losses["pit_l1_loss"] = w.l1 * auraloss.pit_min(
                auraloss.l1_loss, decoded, reals)
        if w.l2 > 0:
            losses["pit_l2_loss"] = w.l2 * auraloss.pit_min(
                auraloss.mse_loss, decoded, reals)
        if self.disc is not None and warmed_up:
            _, adv, fm = encodec_discriminator_loss(self.disc, reals,
                                                    decoded)
            losses["loss_adv"] = w.adversarial * adv
            losses["feature_matching_loss"] = w.feature_matching * fm
        total = sum(losses.values())
        return total, {**losses, "decoded_std": _population_std(decoded)}

    def gen_step(self, state: LDMState, latents: Tensor, reals: Tensor,
                 warmed_up: bool = True, *, mesh=None
                 ) -> Tuple[LDMState, Dict]:
        """One decoder update and its EMA. The metrics are tensors on the
        device (reading them syncs). With ``mesh``, ``latents`` and
        ``reals`` are this rank's rows and the step is the global batch's
        (the PIT permutation chosen on the global loss, the gradient
        averaged over the ranks before the clip, the metrics averaged)."""
        params = list(state.decoder.parameters())
        with torch.enable_grad(), parallel.sharded(mesh):
            loss, aux = self.gen_loss(latents, reals, warmed_up)
            grads = list(torch.autograd.grad(loss, params))
        parallel.all_reduce_grads_(grads, mesh)
        state.gen_optimizer.step(grads)
        ema_update_(state.ema_decoder, state.decoder, self.ema_decay)
        state.step += 1
        metrics = {"train/loss": loss.detach(), **{
            f"train/{k}": v.detach() for k, v in aux.items()}}
        return state, parallel.all_reduce_metrics(metrics, mesh)

    def disc_step(self, state: LDMState, latents: Tensor, reals: Tensor, *,
                  mesh=None) -> Tuple[LDMState, Dict]:
        """One discriminator update on the current decoder's output
        (reference: src/ldm.py:449-471); ``mesh`` as ``gen_step``'s."""
        decoded = self.latent_trainer.decode(latents, reals.shape[-1])
        params = list(state.disc.parameters())
        with torch.enable_grad(), parallel.sharded(mesh):
            loss, _, _ = encodec_discriminator_loss(state.disc, reals,
                                                    decoded)
            grads = list(torch.autograd.grad(loss, params))
        parallel.all_reduce_grads_(grads, mesh)
        state.disc_optimizer.step(grads)
        state.step += 1
        return state, parallel.all_reduce_metrics(
            {"train/discriminator_loss": loss.detach()}, mesh)

    def use_disc_this_step(self, step: int) -> bool:
        """The GAN alternation (reference: src/ldm.py:449-456): odd steps,
        from the start with warmup_mode 'adv', after ``warmup_steps`` with
        'full'."""
        if self.disc is None:
            return False
        warmed = step >= self.warmup_steps
        return bool(step % 2) and (
            (self.warmup_mode == "full" and warmed)
            or self.warmup_mode == "adv")
