"""WAV reading and writing (the port's copy of ditsep_tpu/data/wsj0_mix.py:
read_wav / write_wav): reading through the native library
(``ditsep_tpu_torch.native``) when it is built, else scipy; writing
through scipy."""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Load a wav file as float32 in [-1, 1]: (T,) mono or (C, T). A path
    goes through the native decoder when it is built; a file object (a tar
    member's bytes) through scipy."""
    from ditsep_tpu_torch import native

    r = native.load_wav(path) if isinstance(path, (str, os.PathLike)) \
        else None
    if r is not None:
        data, fs = r
        return (data[0] if data.shape[0] == 1 else data), fs
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
