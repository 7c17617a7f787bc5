"""Latent-domain DiffSep: score matching and separation inside the
OobleckVAE latent space (port of ditsep_tpu/training/diffsep_latent.py:
30-181; reference: src/diffsep_latent.py).

The losses, the optimizer, the train step's update and the samplers are
DiffSepTrainer's; the latent state (B, n_src, D, Tl) goes through their
rank-generic reductions. Around them: the VAE encodes the padded mixture
and targets (the sources folded into the batch) and decodes the
estimates. The VAE is frozen, as the reference's latent config keeps it
(``trainable_vae: False``): its parameters take no gradient, it encodes
under ``torch.no_grad()``, and neither the optimizer, the EMA nor the
checkpoint holds it (they hold ``state.model``, the score model).

The VAE's posterior draws are explicit as the losses' are: from
``generator``, or from ``draws`` by role (training/diffsep.py):

* ``enc_mix_z`` (B, D, Tl) standard normals of the mixture's posterior
  sample (the JAX code's first encoder key, drawn in its (B, Tl, D)
  layout);
* ``enc_tgt_z`` (B * n_src, D, Tl) those of the targets' (its second).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ditsep_tpu_torch import parallel
from ditsep_tpu_torch.models.oobleck import vae_sample
from ditsep_tpu_torch.sdes import ab2_sample, pc_sample
from ditsep_tpu_torch.training import losses as loss_lib
from ditsep_tpu_torch.training.diffsep import (
    DiffSepTrainer, Draws, TrainState, _draw, _mode,
)
from ditsep_tpu_torch.utils import separate as sep_utils

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LatentDiffSepTrainer(DiffSepTrainer):
    """DiffSepTrainer on VAE latents: ``model`` is a LatentScoreModelNCSNpp,
    ``vae`` a frozen OobleckVAE on the same device."""

    vae: Optional[nn.Module] = None

    @torch.no_grad()
    def _encode(self, audio: Tensor, name: str, sample: bool, generator,
                draws: Draws) -> Tensor:
        """Pad to the hop and encode (B, 1, T) -> (B, D, Tl): the
        posterior sample with the draw ``name`` when ``sample``, else the
        mode."""
        audio = sep_utils.pad_to_hop(audio, self.vae.downsampling_ratio)
        mean, scale = self.vae.moments(audio)
        if not sample:
            return mean
        z = _draw(draws, name, mean.shape, "normal", generator, mean.device)
        return vae_sample(mean, scale, z)[0]

    def encode(self, mix: Tensor, target: Optional[Tensor], *,
               sample: Optional[bool] = None, generator=None,
               draws: Draws = None) -> Tuple[Tensor, Optional[Tensor]]:
        """mix (B, 1, T) -> (B, 1, D, Tl) and target (B, n, T) -> (B, n, D,
        Tl), each padded to the VAE hop first; the sources are folded into
        the batch for one encoder call. A posterior sample when ``sample``
        (by default: when ``generator`` or ``draws`` is given), else the
        mode (ditsep_tpu/training/diffsep_latent.py:44-67)."""
        if sample is None:
            sample = generator is not None or draws is not None
        mix_lat = self._encode(mix, "enc_mix_z", sample, generator,
                               draws)[:, None]
        tgt_lat = None
        if target is not None:
            b, n, t = target.shape
            lat = self._encode(target.reshape(b * n, 1, t), "enc_tgt_z",
                               sample, generator, draws)
            tgt_lat = lat.reshape(b, n, *lat.shape[1:])
        return mix_lat, tgt_lat

    @torch.no_grad()
    def decode(self, est: Tensor, target_dim: Optional[int] = None
               ) -> Tensor:
        """(B, n_src, D, Tl) -> (B, n_src, T) waveforms, cropped to
        ``target_dim`` samples, without gradients (separation)."""
        return self.decode_grad(est, target_dim)

    def decode_grad(self, est: Tensor, target_dim: Optional[int] = None
                    ) -> Tensor:
        """``decode`` with gradients through the VAE's decoder where its
        parameters take them (the LDM decoder finetune, training/ldm.py;
        ditsep_tpu/training/diffsep_latent.py:69-83 is differentiable)."""
        b, n, d, tl = est.shape
        dec = self.vae.decode(est.reshape(b * n, d, tl))
        assert dec.shape[1] == 1, (
            "latent separation decodes mono waveforms; a multi-channel VAE "
            f"(out_channels={dec.shape[1]}) would be flattened into time")
        dec = dec.reshape(b, n, -1)
        return dec if target_dim is None else dec[..., :target_dim]

    def training_loss_latent(self, model, mix: Tensor, target: Tensor, *,
                             generator=None, draws: Draws = None) -> Tensor:
        """Encode (a posterior sample) then the training loss on the
        latents; no ``normalize_batch``, as the reference encodes the raw
        batch (:94-101)."""
        mix_lat, tgt_lat = self.encode(mix, target, sample=True,
                                       generator=generator, draws=draws)
        return self.training_loss(model, mix_lat, tgt_lat,
                                  generator=generator, draws=draws)

    def train_step_latent(self, state: TrainState,
                          batch: Tuple[Tensor, Tensor], *, generator=None,
                          draws: Draws = None, mesh=None
                          ) -> Tuple[TrainState, Dict]:
        """One step on a waveform batch, the VAE frozen: encode -> loss ->
        grad -> clip -> Adam -> EMA of the score model (:103-125). With
        ``mesh`` the global batch's step (``train_step``'s), the posterior
        draws the global batch's too."""
        with parallel.sharded(mesh):
            mix_lat, tgt_lat = self.encode(*batch, sample=True,
                                           generator=generator, draws=draws)
        return self._apply_step(state, mix_lat, tgt_lat, generator=generator,
                                draws=draws, mesh=mesh)

    @torch.no_grad()
    def val_score_loss_latent(self, model, batch, *, generator=None,
                              draws: Draws = None, mesh=None) -> Tensor:
        model = self.model if model is None else model
        with _mode(model, False), parallel.sharded(mesh):
            loss = self.training_loss_latent(model, *batch,
                                             generator=generator,
                                             draws=draws)
        return parallel.all_reduce_mean_(loss, mesh)

    @torch.no_grad()
    def sample_latents(self, mix: Tensor, *, latent: bool = False,
                       N: Optional[int] = None,
                       enc_noise: Optional[Tensor] = None,
                       sampler: str = "pc",
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[Sequence] = None,
                       model: Optional[nn.Module] = None
                       ) -> Tuple[Tensor, int]:
        """Encode (a posterior sample, its draw ``enc_noise`` (B, D, Tl) or
        from ``generator``) -> reverse sampling in the latent space.
        ``latent``: ``mix`` is already the (B, 1, D, Tl) latent mixture.
        The sampler is PC with the reverse-diffusion predictor and the ald
        corrector, or ab2 (one score evaluation a step); ``noise`` is its
        explicit draws (see its docstring). Returns ((B, n_src, D, Tl)
        latent estimates, nfe)."""
        if sampler not in ("pc", "ab2"):
            raise ValueError(f"unknown sampler {sampler!r}")
        cfg = self.cfg
        if not latent:
            draws = None if enc_noise is None else {"enc_mix_z": enc_noise}
            mix, _ = self.encode(mix, None, sample=True, generator=generator,
                                 draws=draws)
        score_fn = lambda x, t, y: self.model_fwd(x, t, y, model)  # noqa
        kw = dict(N=cfg.sampler_N if N is None else N, eps=cfg.t_eps,
                  n_spkrs=cfg.n_speakers, generator=generator, noise=noise)
        if sampler == "ab2":
            return ab2_sample(self.sde, score_fn, mix, **kw)
        return pc_sample(
            self.sde, score_fn, mix, predictor="reverse_diffusion",
            corrector="ald", snr=cfg.sampler_snr,
            corrector_steps=cfg.sampler_corrector_steps, denoise=True, **kw)

    def separate_latent(self, mix: Tensor, *,
                        target_dim: Optional[int] = None,
                        **kwargs) -> Tuple[Tensor, int]:
        """``sample_latents`` (its keywords) -> decode, cropped to
        ``target_dim`` samples (:127-158). Returns ((B, n_src, T)
        estimates, nfe)."""
        est, nfe = self.sample_latents(mix, **kwargs)
        return self.decode(est, target_dim), nfe

    def val_metrics_latent(self, model, batch, *, generator=None,
                           mesh=None, return_est: bool = False, **kwargs):
        """Latent separation (``kwargs``: ``sample_latents``'s) + SI-SDR,
        with zero_mean=False as the reference's latent config sets it
        (:160-181); with ``mesh`` the global batch's. With ``return_est``
        (metrics, this rank's waveform estimates)."""
        mix, target = batch
        with parallel.sharded(mesh):
            est, _ = self.separate_latent(mix, target_dim=target.shape[-1],
                                          generator=generator, model=model,
                                          **kwargs)
        si_sdr = loss_lib.si_sdr_loss(est, target, zero_mean=False,
                                      clamp_db=30.0)
        metrics = {"val/si_sdr": parallel.all_reduce_mean_(si_sdr, mesh)}
        return (metrics, est) if return_est else metrics
