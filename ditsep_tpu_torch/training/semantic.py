"""Semantic reconstruction loss: decoded audio against the target in the
feature space of a frozen speech SSL encoder, with per-layer
std-normalised L1 (port of ditsep_tpu/training/semantic.py; reference:
stable-audio-tools training/losses/semantic.py:15-98 ``HubertLoss``).

The encoder comes from a torchaudio pipeline bundle, whose weights need a
download: ``HubertLoss`` loads it at its first call and raises, naming
what is missing, where torchaudio or the bundle's weights are not there.
It never returns a loss it did not compute. ``semantic_feature_l1`` is the
core (layer features in, loss out), tested without weights.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

_BUNDLES = ("HUBERT_LARGE", "WAVLM_LARGE", "WAV2VEC2_LARGE_LV60K")


def semantic_feature_l1(feats_x: Sequence, feats_y: Sequence,
                        feature_ids: Optional[List[int]] = None,
                        weight: float = 1.0, eps: float = 1e-5) -> Tensor:
    """Mean over the selected layers of mean|fx - fy| / (std(fy) + eps),
    times ``weight`` (reference: semantic.py:69-80). The std is the
    population std (numpy's and JAX's, ``correction=0``), not torch's
    default unbiased one. Takes tensors or arrays."""
    loss, denom = 0.0, 0
    for i, (fx, fy) in enumerate(zip(feats_x, feats_y)):
        if feature_ids is not None and i not in feature_ids:
            continue
        fx, fy = torch.as_tensor(fx), torch.as_tensor(fy)
        loss = loss + (fx - fy).abs().mean() / (
            torch.std(fy, correction=0) + eps)
        denom += 1
    if denom == 0:
        raise ValueError("no feature layers selected")
    return weight * loss / denom


class HubertLoss:
    """The frozen speech-SSL feature loss (reference: semantic.py:15-98).
    ``feature_ids`` None compares every transformer layer; [-1] the conv
    feature extractor's output only (the reference's conv_features
    mode)."""

    def __init__(self, feature_ids: Optional[List[int]] = None,
                 weight: float = 1.0, model_name: str = "HUBERT_LARGE"):
        if model_name not in _BUNDLES:
            raise ValueError(f"Unsupported model_name: {model_name}")
        self.feature_ids = feature_ids
        self.weight = weight
        self.model_name = model_name
        self._model = None

    def _load(self):
        if self._model is None:
            try:
                import torchaudio
            except ImportError as e:
                raise RuntimeError(
                    "HubertLoss needs torchaudio, which is not installed")\
                    from e
            try:
                bundle = getattr(torchaudio.pipelines, self.model_name)
                model = bundle.get_model()
            except Exception as e:
                raise RuntimeError(
                    f"HubertLoss could not load the {self.model_name} "
                    f"weights (torchaudio downloads them): {e!r}") from e
            self._model = model.eval().requires_grad_(False)
        return self._model

    @property
    def available(self) -> bool:
        try:
            self._load()
            return True
        except RuntimeError:
            return False

    @property
    def conv_only(self) -> bool:
        return self.feature_ids is not None and list(self.feature_ids) == [-1]

    def _features(self, wav) -> List[Tensor]:
        model = self._load()
        x = torch.as_tensor(np.asarray(wav, np.float32) if not isinstance(
            wav, Tensor) else wav.float())
        x = x.reshape(-1, x.shape[-1])
        with torch.no_grad():
            if self.conv_only:
                feats, _ = model.model.feature_extractor(x, None)
                return [feats]
            feats, _ = model.extract_features(x)
            return list(feats)

    def __call__(self, x, y) -> float:
        """x, y: (B, C, T) or (B, T) waveforms at 16 kHz (the bundles'
        rate; resample before)."""
        ids = None if self.conv_only else self.feature_ids
        return float(semantic_feature_l1(self._features(x),
                                         self._features(y), ids,
                                         self.weight))
