"""WAV reading and writing through scipy (the port's copy of the scipy path
of ditsep_tpu/data/wsj0_mix.py:read_wav / write_wav)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a wav file as float32 in [-1, 1]: (T,) mono or (C, T)."""
    fs, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.T  # (C, T)
    return data, fs


def write_wav(path: str, data: np.ndarray, fs: int) -> None:
    """Write float audio in [-1, 1] as 16-bit PCM (clipped)."""
    data = np.asarray(data, np.float32)
    wavfile.write(path, fs, (np.clip(data, -1, 1) * 32767).astype(np.int16))
