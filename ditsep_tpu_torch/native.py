"""ctypes binding of the native IO library, ``native/ditsep_io.cpp`` (port
of ditsep_tpu/native.py): WAV decoding to float32, 16-bit PCM writing and
centred batch collation on the host.

The port compiles the repository's source itself, with ``g++ -O3 -fPIC
-std=c++17 -shared``, at first use, into ``build/ditsep_tpu_torch/
libditsep_io-<hash>.so`` (the hash of the source and the flags; the
directory is gitignored and ``native/`` is never written). Concurrent
builds (test workers) each compile to a temporary name and rename it
into place. Without a compiler the functions return None (False for
``write_wav``) and the callers take their numpy / scipy paths, as the JAX
package's do: host IO, not the card. ``calls`` counts the calls that went
through the library, by function.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "ditsep_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "ditsep_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

calls = {"load_wav": 0, "write_wav": 0, "collate_center": 0}
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libditsep_io-{digest[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load the library, building it if needed; None when it cannot be
    built."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        out = library_path()
        if not out.exists() and not _build(out):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(out))
        lib.ditsep_load_wav_f32.restype = ctypes.c_long
        lib.ditsep_load_wav_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.ditsep_write_wav_pcm16.restype = ctypes.c_int
        lib.ditsep_write_wav_pcm16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_int, ctypes.c_int]
        lib.ditsep_collate_center.restype = None
        lib.ditsep_collate_center.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def load_wav(path) -> Optional[Tuple[np.ndarray, int]]:
    """Decode a WAV -> ((C, T) float32, fs); None without the library or
    for a file it cannot read."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        # every sample format it reads has at least 2 bytes a sample, so
        # the file size over 2 bounds the decoded sample count
        max_samples = os.path.getsize(path) // 2 + 64
    except OSError:
        return None
    buf = np.empty((max_samples,), np.float32)
    ch = ctypes.c_int(0)
    fs = ctypes.c_int(0)
    frames = lib.ditsep_load_wav_f32(
        os.fsencode(path),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_samples,
        ctypes.byref(ch), ctypes.byref(fs))
    if frames < 0:
        return None
    calls["load_wav"] += 1
    c = ch.value
    return buf[: frames * c].reshape(frames, c).T.copy(), fs.value


def write_wav(path, data: np.ndarray, fs: int) -> bool:
    """Write (C, T) or (T,) float audio as 16-bit PCM; False without the
    library or on a write error."""
    lib = get_lib()
    if lib is None:
        return False
    d = np.ascontiguousarray(np.atleast_2d(data), np.float32)
    c, t = d.shape
    inter = np.ascontiguousarray(d.T)  # interleaved frames
    r = lib.ditsep_write_wav_pcm16(
        os.fsencode(path),
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, c, fs)
    calls["write_wav"] += 1
    return r == 0


def collate_center(signals: Sequence[np.ndarray], out_len: int
                   ) -> Optional[np.ndarray]:
    """Centred collation of 1-D float32 signals -> (n, out_len); None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    sigs = [np.ascontiguousarray(s.reshape(-1), np.float32)
            for s in signals]
    n = len(sigs)
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for s in sigs])
    lens = (ctypes.c_long * n)(*[s.shape[0] for s in sigs])
    out = np.empty((n, out_len), np.float32)
    lib.ditsep_collate_center(
        ptrs, lens, n, out_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    calls["collate_center"] += 1
    return out
