"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

The counterpart of ditsep_tpu/ops/pallas_kernels.py. Each kernel's CUDA
C++ source lives in ``ditsep_tpu_torch/csrc/``. At first use it is compiled
by ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
cached under ``build/ditsep_tpu_torch/`` by a hash of the source, and
loaded with ``ctypes``. Nothing is built or imported when this module is
imported, so the CPU tests can import it on a machine without nvcc.

Rules every wrapper keeps:

* a CPU tensor never reaches a wrapper here: the callers in ``ops/`` send
  it to the plain version;
* a CUDA tensor launches the kernel or raises (unsupported input, failed
  build, refused launch); there is no fallback;
* the kernel runs on the current stream and allocates nothing: the wrapper
  allocates the output with ``torch.empty``;
* ``<kernel>.launches`` counts the launches, so a run can show that its
  main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ditsep_tpu_torch.ops.upfirdn2d import pad_or_crop, setup_fir_kernel, upfirdn2d

Tensor = torch.Tensor

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ditsep_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One ``csrc/<name>.cu`` source built into ``lib<name>-<hash>.so``."""

    def __init__(self, source: str):
        self.source = CSRC_DIR / source
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None  # None: cache hit
        self.build_log = ""

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(str(self.build()))
        return self._lib

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists."""
        src = self.source.read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {self.source}:\n"
                f"{self.build_log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half
        return out


# ---------------------------------------------- FIR 2x downsample (4 taps) --
def separable_taps(k: np.ndarray, gain: float) -> Tuple[list, list]:
    """Flipped, normalized per-axis taps of a separable FIR kernel, as the
    float32 values both the kernel and its plain version multiply by."""
    k1 = k / k.sum()
    flip = lambda t: [float(np.float32(v)) for v in t[::-1]]
    return flip(k1), flip(k1 * gain)


def _fir_down_axis(x: Tensor, taps: Sequence[float], factor: int,
                   dim: int) -> Tensor:
    """Flipped-tap FIR along ``dim`` with pad ((p+1)//2, p//2), then keep
    every ``factor``-th sample (p = len(taps) - factor)."""
    p = len(taps) - factor
    n_out = (x.shape[dim] + p - len(taps)) // factor + 1
    xp = pad_or_crop(x, dim, (p + 1) // 2, p // 2)
    acc = None
    for a, t in enumerate(taps):
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(a, a + factor * (n_out - 1) + 1, factor)
        term = t * xp[tuple(idx)]
        acc = term if acc is None else acc + term
    return acc


def downsample_2d_plain(x: Tensor, k: Optional[Sequence[float]] = None,
                        factor: int = 2, gain: float = 1.0) -> Tensor:
    """Plain PyTorch version of ``fir_down2d``: ``downsample_2d`` on NCHW.

    A 1-D (separable) kernel runs as an H pass then a W pass over strided
    views, in float32 for bf16/fp16 inputs (the kernel's f32 accumulation),
    cast back at the end. A 2-D kernel goes through ``upfirdn2d``."""
    k_arr = np.asarray([1.0] * factor if k is None else k, np.float64)
    if k_arr.ndim != 1:
        kern = setup_fir_kernel(k_arr, gain)
        p = kern.shape[0] - factor
        return upfirdn2d(x, kern, down=factor, pad=((p + 1) // 2, p // 2))
    taps_h, taps_w = separable_taps(k_arr, gain)
    work = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    y = _fir_down_axis(work, taps_h, factor, dim=2)
    y = _fir_down_axis(y, taps_w, factor, dim=3)
    return y.to(x.dtype)


class FirDown2d:
    """Wrapper of ``csrc/fir_down2d.cu``: 4-tap separable FIR + 2x
    decimation on both spatial axes of a logical NCHW tensor, one pass.

    Replaces ditsep_tpu/ops/pallas_kernels.py:fir_down2_h_pallas /
    downsample_2d_pallas. Takes f32 or bf16, contiguous NCHW or
    channels_last strides, any H, W >= 2; returns (N, C, H//2, W//2) in
    the input's dtype and memory format."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self):
        self.library = CudaLibrary("fir_down2d.cu")
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = self.library.load().fir_down2d
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                           + [ctypes.c_int64] * 8
                           + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, x: Tensor, taps_h: Sequence[float],
                 taps_w: Sequence[float]) -> Tensor:
        """``taps_h`` / ``taps_w``: the 4 flipped taps of each axis."""
        if x.device.type != "cuda":
            raise ValueError(f"fir_down2d needs a CUDA tensor, got {x.device}")
        if x.dtype not in self._DTYPES:
            raise ValueError(f"fir_down2d takes float32 or bfloat16, "
                             f"got {x.dtype}")
        if x.ndim != 4:
            raise ValueError(f"fir_down2d takes (N, C, H, W), got {x.shape}")
        n, c, h, w = x.shape
        if h < 2 or w < 2:
            raise ValueError(f"fir_down2d needs H, W >= 2, got {x.shape}")
        if len(taps_h) != 4 or len(taps_w) != 4:
            raise ValueError("fir_down2d takes 4 taps per axis")
        if x.is_contiguous():
            fmt, channels_last = torch.contiguous_format, 0
        elif x.is_contiguous(memory_format=torch.channels_last):
            fmt, channels_last = torch.channels_last, 1
        else:
            raise ValueError(
                f"fir_down2d takes contiguous NCHW or channels_last strides, "
                f"got strides {x.stride()}")
        y = torch.empty((n, c, h // 2, w // 2), dtype=x.dtype,
                        device=x.device, memory_format=fmt)
        if y.numel() == 0:
            return y
        fn = self._function()
        taps = (ctypes.c_float * 8)(*taps_h, *taps_w)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), y.data_ptr(), self._DTYPES[x.dtype],
                     n, c, h, w, *x.stride(), channels_last,
                     ctypes.cast(taps, ctypes.c_void_p), stream)
        if err != 0:
            raise RuntimeError(f"fir_down2d launch failed: CUDA error {err}")
        self.launches += 1
        return y


fir_down2d = FirDown2d()


def downsample_2d_cuda(x: Tensor, k: Optional[Sequence[float]] = None,
                       factor: int = 2, gain: float = 1.0) -> Tensor:
    """``downsample_2d`` on a CUDA tensor through ``fir_down2d``; raises on
    every configuration the kernel does not take (factor != 2, a kernel
    that is not 1-D with 4 taps, another dtype or stride pattern)."""
    k_arr = np.asarray([1.0] * factor if k is None else k, np.float64)
    if factor != 2 or k_arr.ndim != 1 or k_arr.shape[0] != 4:
        raise ValueError(
            f"fir_down2d takes factor 2 and a separable 4-tap kernel, got "
            f"factor={factor}, k shape {k_arr.shape}")
    taps_h, taps_w = separable_taps(k_arr, gain)
    return fir_down2d(x, taps_h, taps_w)
