"""DiffSep separation around a score model (port of
ditsep_tpu/training/diffsep.py: DiffSepConfig and, of DiffSepTrainer, the
non-EDM ``model_fwd`` and the PC branch of ``separate``). Training is not
ported yet."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ditsep_tpu_torch.sdes import BaseSDE, MixSDE, pc_sample
from ditsep_tpu_torch.utils import separate as sep_utils

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DiffSepConfig:
    """Hyperparameters mirroring the reference model config."""

    n_speakers: int = 2
    t_eps: float = 0.03
    t_rev_init: float = 0.03
    ema_decay: float = 0.999
    time_sampling_strategy: str = "uniform"
    train_source_order: str = "power"
    init_hack: int = 5
    init_hack_p: float = 0.1
    mmnr_thresh_pit: float = -10.0
    lr: float = 2e-4
    lr_warmup: Optional[int] = None
    grad_clip: float = 5.0
    accumulate_grad_batches: int = 1
    sampler_N: int = 30
    sampler_snr: float = 0.5
    sampler_corrector_steps: int = 1
    network_scaling: str = "1/sigma"
    c: str = "edm"
    sigma_data: float = 0.1


@dataclasses.dataclass(frozen=True)
class DiffSepTrainer:
    """``model`` is an nn.Module (xt, time, mix) -> score holding its own
    parameters; ``sde`` is a MixSDE (the other SDE families are not
    ported yet)."""

    model: nn.Module
    sde: BaseSDE
    cfg: DiffSepConfig = DiffSepConfig()

    def __post_init__(self):
        if not isinstance(self.sde, MixSDE):
            raise NotImplementedError(
                f"{type(self.sde).__name__} is not ported yet (MixSDE only)")

    def model_fwd(self, xt: Tensor, time: Tensor, mix: Tensor) -> Tensor:
        """The score network (the non-EDM branch)."""
        return self.model(xt, time, mix)

    @torch.no_grad()
    def separate(self, mix: Tensor, *, N: Optional[int] = None,
                 snr: Optional[float] = None,
                 corrector_steps: Optional[int] = None,
                 sampler: str = "pc", lengths: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Sequence] = None) -> Tuple[Tensor, int]:
        """Normalize -> PC sampling (reverse_diffusion + ald2) ->
        denormalize. ``mix`` is (B, 1, T) on the model's device. Returns
        (estimates (B, n_speakers, T), nfe)."""
        if sampler != "pc":
            raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
        if lengths is not None:
            raise NotImplementedError("per-item lengths are not ported yet")
        cfg = self.cfg
        (mix, _), mean, std = sep_utils.normalize_batch((mix, None))
        est, nfe = pc_sample(
            self.sde, self.model_fwd, mix,
            predictor="reverse_diffusion", corrector="ald2",
            N=cfg.sampler_N if N is None else N,
            snr=cfg.sampler_snr if snr is None else snr,
            corrector_steps=(cfg.sampler_corrector_steps
                             if corrector_steps is None else corrector_steps),
            denoise=True, eps=cfg.t_eps, n_spkrs=cfg.n_speakers,
            generator=generator, noise=noise)
        return sep_utils.denormalize_batch(est, mean, std), nfe
