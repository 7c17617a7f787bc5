"""Pretrained-checkpoint download and load helpers (port of
ditsep_tpu/utils/hub.py; reference: src/inference/separate.py:36-80
downloads fakufaku/diffsep from the HF hub; scripts/get_diffsep_ckpt.py,
get_vae_start.py). The download is gated on the optional
``huggingface_hub`` package; the torch checkpoints it fetches load through
``models.torch_import``.
"""
from __future__ import annotations

from typing import Optional

import torch.nn as nn


def download_checkpoint(repo_id: str = "fakufaku/diffsep",
                        filename: str = "checkpoints/"
                                        "epoch-029_si_sdr-14.804.ckpt",
                        cache_dir: Optional[str] = None) -> str:
    """Fetch a checkpoint file from the Hugging Face hub; returns the
    local path. Needs ``huggingface_hub``."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ImportError(
            "huggingface_hub is not installed; download the checkpoint "
            "manually and point the importer at the file") from e
    return hf_hub_download(repo_id=repo_id, filename=filename,
                           cache_dir=cache_dir)


def load_reference_diffsep_params(model: nn.Module, ckpt_path: str,
                                  use_ema: bool = False) -> nn.Module:
    """Load the reference's DiffSep checkpoint (its keys
    ``score_model.backbone.all_modules...``) into ``model``, a
    ``ScoreModelNCSNpp``, through ``load_torch_ckpt`` and
    ``import_params(prefix="score_model.")``; returns the model. An EMA
    import raises where the state holds ``ema``, as the JAX package's
    does: ``models.import_diffsep_ema`` takes the shadows."""
    from ditsep_tpu_torch.models.torch_import import (
        import_params, load_torch_ckpt,
    )

    state = load_torch_ckpt(ckpt_path)
    import_params(model, state, prefix="score_model.")
    if use_ema and "ema" in state:
        raise NotImplementedError(
            "EMA import needs the torch parameters() ordering; use "
            "models.import_diffsep_ema directly")
    return model
