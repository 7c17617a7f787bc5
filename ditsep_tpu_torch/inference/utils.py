"""Host-side audio preparation for inference inputs (port of
ditsep_tpu/inference/utils.py; reference: stable-audio-tools
inference/utils.py:5-40): numpy, run before the transfer to the device.
"""
from __future__ import annotations

import math

import numpy as np


def _resample(audio: np.ndarray, fs: int, target: int) -> np.ndarray:
    """Polyphase resampling of (C, T) audio from fs to target Hz (scipy's
    ``resample_poly``, as the JAX package's data/webdataset.py)."""
    from scipy.signal import resample_poly

    g = math.gcd(fs, target)
    return np.asarray(resample_poly(audio, target // g, fs // g, axis=-1),
                      np.float32)


def set_audio_channels(audio: np.ndarray, target_channels: int
                       ) -> np.ndarray:
    """(B, C, T) or (B, T) -> (B, target_channels, T): mono is the channel
    mean, stereo duplicates mono or drops channels past two."""
    if audio.ndim == 2:
        audio = audio[:, None, :]
    if target_channels == 1:
        audio = audio.mean(axis=1, keepdims=True)
    elif target_channels == 2:
        if audio.shape[1] == 1:
            audio = np.repeat(audio, 2, axis=1)
        elif audio.shape[1] > 2:
            audio = audio[:, :2, :]
    return audio


def prepare_audio(audio: np.ndarray, in_sr: int, target_sr: int,
                  target_length: int, target_channels: int) -> np.ndarray:
    """Resample, pad or crop to ``target_length``, set the channels: (T,),
    (C, T) or (B, C, T) in, (B, target_channels, target_length) out."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, None, :]
    elif audio.ndim == 2:
        audio = audio[None, :, :]
    if in_sr != target_sr:
        audio = np.stack([_resample(a, in_sr, target_sr) for a in audio])
    t = audio.shape[-1]
    if t >= target_length:
        audio = audio[..., :target_length]
    else:
        audio = np.pad(audio, ((0, 0), (0, 0), (0, target_length - t)))
    return set_audio_channels(audio, target_channels)
