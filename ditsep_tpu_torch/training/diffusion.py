"""Diffusion training for the stable-audio models (port of
ditsep_tpu/training/diffusion.py, in part).

Only ``CondRouting`` is ported: which conditioner outputs feed which model
input, as the model factory builds it for generation. The training half
(``sample_timesteps``, ``diffusion_targets``, ``create_source_mixture``,
``random_inpaint_mask``, ``DiffusionTrainer``, ``DiffAETrainer``) is ROADMAP
A16.4 and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CondRouting:
    """Which conditioner outputs feed which model input (reference:
    models/diffusion.py:112-214): ``gather(cond)`` concatenates the named
    (embedding, mask) pairs into the DiT's keyword arguments."""

    cross_attn_cond_ids: Tuple[str, ...] = ()
    global_cond_ids: Tuple[str, ...] = ()
    input_concat_ids: Tuple[str, ...] = ()
    prepend_cond_ids: Tuple[str, ...] = ()

    def gather(self, cond: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
               ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.cross_attn_cond_ids:
            out["cross_attn_cond"] = torch.cat(
                [cond[k][0] for k in self.cross_attn_cond_ids], dim=1)
            out["cross_attn_cond_mask"] = torch.cat(
                [cond[k][1] for k in self.cross_attn_cond_ids], dim=1)
        if self.global_cond_ids:
            out["global_embed"] = torch.cat(
                [cond[k][0].reshape(cond[k][0].shape[0], -1)
                 for k in self.global_cond_ids], dim=-1)
        if self.input_concat_ids:
            out["input_concat_cond"] = torch.cat(
                [cond[k][0] for k in self.input_concat_ids], dim=1)
        if self.prepend_cond_ids:
            out["prepend_cond"] = torch.cat(
                [cond[k][0] for k in self.prepend_cond_ids], dim=1)
            out["prepend_cond_mask"] = torch.cat(
                [cond[k][1] for k in self.prepend_cond_ids], dim=1)
        return out


def _training_not_ported(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is diffusion training, not ported yet (ROADMAP A16.4)")
    refuse.__name__ = name
    return refuse


sample_timesteps = _training_not_ported("sample_timesteps")
diffusion_targets = _training_not_ported("diffusion_targets")
create_source_mixture = _training_not_ported("create_source_mixture")
random_inpaint_mask = _training_not_ported("random_inpaint_mask")
DiffusionTrainer = _training_not_ported("DiffusionTrainer")
DiffAETrainer = _training_not_ported("DiffAETrainer")
