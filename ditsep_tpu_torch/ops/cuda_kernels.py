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
import math
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

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
    """One ``csrc/<name>.cu`` source built into ``lib<name>-<hash>.so``.

    ``edits``, (text, replacement) pairs, build a variant of the source
    (``scripts/conv_ablation.py`` times such variants): each text must be
    in the source, and the edited source is compiled from the build
    directory under its own hash."""

    def __init__(self, source: str,
                 edits: Sequence[Tuple[str, str]] = ()):
        self.source = CSRC_DIR / source
        self.edits = tuple(edits)
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None  # None: cache hit
        self.build_log = ""

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._lib = ctypes.CDLL(str(self.build()))
        return self._lib

    def target(self) -> Tuple[str, Path]:
        """The (edited) source text and the library it builds into."""
        src = self.source.read_text()
        for old, new in self.edits:
            if old not in src:
                raise RuntimeError(f"edit of {self.source.name}: {old!r} is "
                                   "not in the source")
            src = src.replace(old, new)
        digest = hashlib.sha256((src + " ".join(NVCC_FLAGS)).encode())
        name = f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"
        return src, BUILD_DIR / name

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists."""
        src, out = self.target()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cu = self.source
        if self.edits:
            cu = out.with_suffix(".cu")
            cu.write_text(src)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(cu)]
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


def bf16_ulp(v: float) -> float:
    """One bf16 unit in the last place at magnitude ``v``: the tolerance of
    a bf16 kernel against its plain version."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7)


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


FIR_THREADS = 256      # threads a block of fir_down2d, at most
FIR_MAX_GRID_Y = 65535  # planes (NCHW) or images (channels_last) a launch
                        # spans in gridDim.y; the kernel loops past it
# output rows a thread by layout, the kernel's kRowsNchw / kRowsNhwc: the
# fastest at the flagship's level-0 shapes on an H100
FIR_ROWS = {"nchw": 2, "channels_last": 5}
_FIR_ESIZE = {torch.float32: 4, torch.bfloat16: 2}


def _dense(shape: Sequence[int], strides: Sequence[int],
           order: Sequence[int]) -> bool:
    """Whether ``strides`` are dense in ``order`` (innermost axis first),
    ignoring axes of size 1, as ``Tensor.is_contiguous`` does."""
    want = 1
    for ax in order:
        if shape[ax] != 1 and strides[ax] != want:
            return False
        want *= shape[ax]
    return True


def fir_down2d_plan(shape: Sequence[int], strides: Sequence[int],
                    dtype: torch.dtype, misalign: int,
                    force_path: Optional[str] = None) -> dict:
    """The launch plan of ``csrc/fir_down2d.cu`` for an (N, C, H, W) tensor
    of these strides and dtype whose data pointer is ``misalign`` bytes
    past a 16-byte boundary.

    ``layout``: "nchw" (contiguous, checked first as ``Tensor.
    is_contiguous`` is) or "channels_last"; ``path``: "vector" (16-byte
    loads and stores: NCHW with W a multiple of 2V, channels_last with C a
    multiple of V, and ``misalign`` 0) or "scalar" (element loads, any
    shape), unless ``force_path`` names one (a "vector" that does not
    apply raises); ``v``: outputs (NCHW) or channels (channels_last) a
    thread stores per output row, V = 4 (f32) or 8 (bf16) on the vector
    path, 1 on the scalar one; ``groups``: such groups in an output row
    (NCHW) or pixel (channels_last); ``rows``: output rows a thread (R,
    ``FIR_ROWS`` of the layout); ``block`` (bx, by) and ``grid`` (gx, gy) as the kernel takes them:
    NCHW bx groups along W x by thread rows of R output rows, gx = column
    tiles x row tiles; channels_last bx channel groups x by output
    columns, gx = channel tiles x column tiles x row tiles; gy planes or
    images, at most 65,535 (the kernel loops past it); ``tile``: output
    rows and columns of a block. Raises ValueError for what the kernel
    does not take."""
    if len(shape) != 4:
        raise ValueError(f"fir_down2d takes (N, C, H, W), got {shape}")
    if dtype not in _FIR_ESIZE:
        raise ValueError(f"fir_down2d takes float32 or bfloat16, got {dtype}")
    n, c, h, w = shape
    if h < 2 or w < 2:
        raise ValueError(f"fir_down2d needs H, W >= 2, got {tuple(shape)}")
    if max(n * c, h, w) >= 2 ** 31:
        raise ValueError(f"fir_down2d indexes with 32 bits: {tuple(shape)}")
    if force_path not in (None, "vector", "scalar"):
        raise ValueError(f"fir_down2d force_path is 'vector' or 'scalar', "
                         f"got {force_path!r}")
    if _dense(shape, strides, (3, 2, 1, 0)):
        layout = "nchw"
    elif _dense(shape, strides, (1, 3, 2, 0)):
        layout = "channels_last"
    else:
        raise ValueError(f"fir_down2d takes contiguous NCHW or channels_last "
                         f"strides, got strides {tuple(strides)}")
    vec = 16 // _FIR_ESIZE[dtype]
    fits = misalign == 0 and (w % (2 * vec) == 0 if layout == "nchw"
                              else c % vec == 0)
    if force_path == "vector" and not fits:
        raise ValueError(f"fir_down2d: the vector path does not apply to "
                         f"{tuple(shape)} {layout} {dtype} at pointer "
                         f"offset {misalign} mod 16")
    path = force_path or ("vector" if fits else "scalar")
    v = vec if path == "vector" else 1
    r = FIR_ROWS[layout]
    ho, wo = h // 2, w // 2
    cdiv = lambda a, b: -(-a // b)
    if layout == "nchw":
        groups = wo // v
        tiles = cdiv(groups, FIR_THREADS)
        bx = groups if tiles == 1 else _round_up(cdiv(groups, tiles), 32)
        by = max(1, min(FIR_THREADS // bx, cdiv(ho, r)))
        gx = cdiv(groups, bx) * cdiv(ho, by * r)
        gy, tile = min(n * c, FIR_MAX_GRID_Y), (by * r, bx * v)
    else:
        groups = c // v
        bx = max(1, min(groups, FIR_THREADS))
        by = max(1, min(FIR_THREADS // bx, wo))
        gx = cdiv(groups, bx) * cdiv(wo, by) * cdiv(ho, r)
        gy, tile = min(n, FIR_MAX_GRID_Y), (r, by)
    if gx >= 2 ** 31:
        raise ValueError(f"fir_down2d: {tuple(shape)} needs {gx} blocks")
    return {"layout": layout, "path": path, "v": v, "groups": groups,
            "rows": r, "block": (bx, by), "grid": (gx, gy), "tile": tile}


class _FirKernel:
    """What the two FIR kernels' wrappers share: the library ``csrc/
    <entry>.cu``, whose C entry takes (in, out, dtype, channels_last,
    vector, N, C, H, W of the full-size side, block, grid, 8 taps,
    stream); the plan cache; the taps' host array; the launch and its
    count. ``_DTYPES``: the C entry's dtype codes."""

    entry = ""
    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}

    def __init__(self):
        self.library = CudaLibrary(f"{self.entry}.cu")
        self.launches = 0
        self._fn = None
        self._plans = {}
        self._taps = {}

    def _function(self):
        if self._fn is None:
            fn = getattr(self.library.load(), self.entry)
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 3 + [ctypes.c_int64] * 4
                           + [ctypes.c_int] * 2
                           + [ctypes.c_int64, ctypes.c_int]
                           + [ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _cached_plan(self, make, *key) -> dict:
        plan = self._plans.get(key)
        if plan is None:
            if len(self._plans) >= 256:  # bound it for callers of many shapes
                self._plans.clear()
            plan = self._plans[key] = make(*key)
        return plan

    def _launch(self, src: Tensor, out_hw: Sequence[int],
                full_hw: Sequence[int], plan: dict,
                taps_h: Sequence[float], taps_w: Sequence[float]) -> Tensor:
        """Allocate the (N, C, *out_hw) output in the plan's layout and
        launch the plan on it; ``full_hw``: the full-size side's (H, W)."""
        if len(taps_h) != 4 or len(taps_w) != 4:
            raise ValueError(f"{self.entry} takes 4 taps per axis")
        n, c = src.shape[:2]
        fmt = (torch.channels_last if plan["layout"] == "channels_last"
               else torch.contiguous_format)
        out = torch.empty((n, c, *out_hw), dtype=src.dtype,
                          device=src.device, memory_format=fmt)
        if out.numel() == 0:
            return out
        fn = self._function()
        key = (*taps_h, *taps_w)
        taps = self._taps.get(key)
        if taps is None:
            taps = self._taps[key] = (ctypes.c_float * 8)(*key)
        (bx, by), (gx, gy) = plan["block"], plan["grid"]
        with torch.cuda.device(src.device):
            err = fn(src.data_ptr(), out.data_ptr(), self._DTYPES[src.dtype],
                     int(fmt is torch.channels_last),
                     int(plan["path"] == "vector"), n, c, *full_hw,
                     bx, by, gx, gy, taps, _stream(src))
        if err != 0:  # 1 (invalid value): a plan that does not fit
            raise RuntimeError(f"{self.entry} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out


class FirDown2d(_FirKernel):
    """Wrapper of ``csrc/fir_down2d.cu``: 4-tap separable FIR + 2x
    decimation on both spatial axes of a logical NCHW tensor, one pass.

    Replaces ditsep_tpu/ops/pallas_kernels.py:fir_down2_h_pallas /
    downsample_2d_pallas. Takes f32 or bf16, contiguous NCHW or
    channels_last strides, any H, W >= 2; returns (N, C, H//2, W//2) in
    the input's dtype and memory format. Each call launches the plan of
    ``fir_down2d_plan`` (cached by shape, strides, dtype and alignment);
    ``force_path`` ("vector" or "scalar") is for the checks that hold the
    two paths to the same bits."""

    entry = "fir_down2d"

    def plan(self, x: Tensor, force_path: Optional[str] = None) -> dict:
        """``fir_down2d_plan`` for ``x``, cached."""
        return self._cached_plan(fir_down2d_plan, tuple(x.shape), x.stride(),
                                 x.dtype, x.data_ptr() % 16, force_path)

    def __call__(self, x: Tensor, taps_h: Sequence[float],
                 taps_w: Sequence[float],
                 force_path: Optional[str] = None) -> Tensor:
        """``taps_h`` / ``taps_w``: the 4 flipped taps of each axis."""
        if x.device.type != "cuda":
            raise ValueError(f"fir_down2d needs a CUDA tensor, got {x.device}")
        h, w = x.shape[2:]
        return self._launch(x, (h // 2, w // 2), (h, w),
                            self.plan(x, force_path), taps_h, taps_w)


fir_down2d = FirDown2d()


# ------------------------ FIR 2x downsample's adjoint (its backward) -------
def _fir_up_axis(g: Tensor, taps: Sequence[float], n_out: int,
                 dim: int) -> Tensor:
    """Adjoint of ``_fir_down_axis`` (4 taps, factor 2) along ``dim``:
    ``n_out`` samples, out[2r] = t1*g[r] + t3*g[r-1] and out[2r+1] =
    t0*g[r+1] + t2*g[r], g zero outside its range."""
    gp = pad_or_crop(g, dim, 1, 1)  # gp[j] = g[j - 1]
    n_even, n_odd = (n_out + 1) // 2, n_out // 2

    def at(start: int, count: int) -> Tensor:
        return gp.narrow(dim, start, count)

    even = taps[1] * at(1, n_even) + taps[3] * at(0, n_even)
    odd = taps[0] * at(2, n_odd) + taps[2] * at(1, n_odd)
    shape = list(g.shape)
    shape[dim] = n_out
    out = g.new_empty(shape)
    idx = [slice(None)] * g.ndim
    idx[dim] = slice(0, None, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, None, 2)
    out[tuple(idx)] = odd
    return out


def downsample_2d_bwd_plain(g: Tensor, k: Sequence[float],
                            in_hw: Tuple[int, int], gain: float = 1.0
                            ) -> Tensor:
    """Plain PyTorch version of ``fir_up2d``: the gradient of
    ``downsample_2d(x, k, 2, gain)`` with respect to its (N, C, H, W) input
    x, ``in_hw`` = (H, W), from the output's gradient ``g`` (N, C, H//2,
    W//2), for a separable 4-tap ``k``.

    The W pass over g, then the H pass, each a*b + c*d over strided views,
    in float32 for bf16 inputs, cast back once: the kernel's order."""
    k_arr = np.asarray(k, np.float64)
    if k_arr.ndim != 1 or k_arr.shape[0] != 4:
        raise ValueError(f"downsample_2d_bwd_plain takes a 4-tap kernel, "
                         f"got shape {k_arr.shape}")
    h, w = in_hw
    if g.shape[2:] != (h // 2, w // 2):
        raise ValueError(f"gradient {tuple(g.shape)} does not fit an input "
                         f"of {h} x {w}")
    taps_h, taps_w = separable_taps(k_arr, gain)
    work = g.float() if g.dtype in (torch.bfloat16, torch.float16) else g
    u = _fir_up_axis(work, taps_w, w, dim=3)
    return _fir_up_axis(u, taps_h, h, dim=2).to(g.dtype)


def fir_up2d_plan(shape: Sequence[int], strides: Sequence[int],
                  dtype: torch.dtype, misalign: int, out_hw: Sequence[int],
                  force_path: Optional[str] = None) -> dict:
    """The launch plan of ``csrc/fir_up2d.cu`` for a gradient g of shape
    (N, C, Ho, Wo) and these strides and dtype, whose data pointer is
    ``misalign`` bytes past a 16-byte boundary, into dx of (N, C, H, W),
    ``out_hw`` = (H, W) with H // 2 = Ho and W // 2 = Wo.

    ``layout`` as ``fir_down2d_plan`` (dx takes g's); ``path``: "vector"
    (NCHW: W a multiple of 2V, V = 2 f32 / 4 bf16 g columns, one 16-byte
    store an output row; channels_last: C a multiple of V, V = 4 f32 / 8
    bf16 channels; ``misalign`` 0) or "scalar" (V = 1, any shape), unless
    ``force_path`` names one; ``v``; ``groups``: column groups of a row
    (NCHW, ceil(W / 2V)) or channel groups (channels_last); ``pairs``:
    output row pairs, ceil(H / 2); ``block`` (bx, by) and ``grid`` (gx,
    gy) as the kernel takes them: NCHW bx groups x by row pairs, gx =
    column tiles x row tiles; channels_last bx channel groups x by quad
    columns, gx = channel tiles x column tiles x row pairs; gy planes or
    images, at most 65,535 (the kernel loops past it). Raises ValueError
    for what the kernel does not take."""
    if len(shape) != 4:
        raise ValueError(f"fir_up2d takes g (N, C, Ho, Wo), got {shape}")
    if dtype not in _FIR_ESIZE:
        raise ValueError(f"fir_up2d takes float32 or bfloat16, got {dtype}")
    n, c, ho, wo = shape
    h, w = out_hw
    if h < 2 or w < 2 or (h // 2, w // 2) != (ho, wo):
        raise ValueError(f"fir_up2d: g {tuple(shape)} does not fit an input "
                         f"of {h} x {w} (H, W >= 2)")
    if max(n * c, h, w) >= 2 ** 31:
        raise ValueError(f"fir_up2d indexes with 32 bits: {tuple(shape)}")
    if force_path not in (None, "vector", "scalar"):
        raise ValueError(f"fir_up2d force_path is 'vector' or 'scalar', "
                         f"got {force_path!r}")
    if _dense(shape, strides, (3, 2, 1, 0)):
        layout = "nchw"
    elif _dense(shape, strides, (1, 3, 2, 0)):
        layout = "channels_last"
    else:
        raise ValueError(f"fir_up2d takes contiguous NCHW or channels_last "
                         f"strides, got strides {tuple(strides)}")
    esize = _FIR_ESIZE[dtype]
    vec = (8 if layout == "nchw" else 16) // esize
    fits = misalign == 0 and (w % (2 * vec) == 0 if layout == "nchw"
                              else c % vec == 0)
    if force_path == "vector" and not fits:
        raise ValueError(f"fir_up2d: the vector path does not apply to "
                         f"{h} x {w} {layout} {dtype} at pointer offset "
                         f"{misalign} mod 16")
    path = force_path or ("vector" if fits else "scalar")
    v = vec if path == "vector" else 1
    pairs = -(-h // 2)
    cdiv = lambda a, b: -(-a // b)
    if layout == "nchw":
        groups = cdiv(w, 2 * v)
        tiles = cdiv(groups, FIR_THREADS)
        bx = groups if tiles == 1 else _round_up(cdiv(groups, tiles), 32)
        by = max(1, min(FIR_THREADS // bx, pairs))
        gx = cdiv(groups, bx) * cdiv(pairs, by)
        gy = min(n * c, FIR_MAX_GRID_Y)
    else:
        groups = c // v
        bx = max(1, min(groups, FIR_THREADS))
        by = max(1, min(FIR_THREADS // bx, cdiv(w, 2)))
        gx = cdiv(groups, bx) * cdiv(cdiv(w, 2), by) * pairs
        gy = min(n, FIR_MAX_GRID_Y)
    if gx >= 2 ** 31:
        raise ValueError(f"fir_up2d: {tuple(shape)} needs {gx} blocks")
    return {"layout": layout, "path": path, "v": v, "groups": groups,
            "pairs": pairs, "block": (bx, by), "grid": (gx, gy)}


class FirUp2d(_FirKernel):
    """Wrapper of ``csrc/fir_up2d.cu``: the adjoint of ``fir_down2d``, dx
    (N, C, H, W) from g (N, C, H//2, W//2), one pass.

    The backward of ``fir_down2d`` (no TPU kernel: the JAX package
    differentiates ditsep_tpu/ops/fir.py:downsample_2d with XLA). Takes f32
    or bf16, contiguous NCHW or channels_last strides, any H, W >= 2;
    returns dx in g's dtype and memory format. Each call launches the plan
    of ``fir_up2d_plan`` (cached by shape, strides, dtype, alignment and
    output size)."""

    entry = "fir_up2d"

    def plan(self, g: Tensor, out_hw: Sequence[int],
             force_path: Optional[str] = None) -> dict:
        """``fir_up2d_plan`` for ``g`` into an ``out_hw`` output, cached."""
        return self._cached_plan(fir_up2d_plan, tuple(g.shape), g.stride(),
                                 g.dtype, g.data_ptr() % 16, tuple(out_hw),
                                 force_path)

    def __call__(self, g: Tensor, taps_h: Sequence[float],
                 taps_w: Sequence[float], out_hw: Sequence[int],
                 force_path: Optional[str] = None) -> Tensor:
        """``taps_h`` / ``taps_w``: the forward's 4 flipped taps of each
        axis; ``out_hw``: the forward input's (H, W)."""
        if g.device.type != "cuda":
            raise ValueError(f"fir_up2d needs a CUDA tensor, got {g.device}")
        plan = self.plan(g, out_hw, force_path)
        return self._launch(g, tuple(out_hw), tuple(out_hw), plan, taps_h,
                            taps_w)


fir_up2d = FirUp2d()


class FirDown2dFunction(torch.autograd.Function):
    """``fir_down2d`` with its backward as the kernel ``fir_up2d``. Saves
    nothing but the taps and the input size; not twice differentiable. A
    gradient in neither layout the kernel takes is made contiguous first
    (a copy)."""

    @staticmethod
    def forward(ctx, x, taps_h, taps_w):
        ctx.args = (tuple(taps_h), tuple(taps_w), tuple(x.shape[2:]))
        return fir_down2d(x, taps_h, taps_w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        taps_h, taps_w, hw = ctx.args
        if not (g.is_contiguous()
                or g.is_contiguous(memory_format=torch.channels_last)):
            g = g.contiguous()
        return fir_up2d(g, taps_h, taps_w, hw), None, None


def downsample_2d_cuda(x: Tensor, k: Optional[Sequence[float]] = None,
                       factor: int = 2, gain: float = 1.0) -> Tensor:
    """``downsample_2d`` on a CUDA tensor through ``fir_down2d``; raises on
    every configuration the kernel does not take (factor != 2, a kernel
    that is not 1-D with 4 taps, another dtype or stride pattern). Where a
    gradient is wanted (grad mode on and ``x.requires_grad``) it goes
    through ``FirDown2dFunction``, whose backward is ``fir_up2d``; else it
    calls the kernel directly."""
    k_arr = np.asarray([1.0] * factor if k is None else k, np.float64)
    if factor != 2 or k_arr.ndim != 1 or k_arr.shape[0] != 4:
        raise ValueError(
            f"fir_down2d takes factor 2 and a separable 4-tap kernel, got "
            f"factor={factor}, k shape {k_arr.shape}")
    taps_h, taps_w = separable_taps(k_arr, gain)
    if torch.is_grad_enabled() and x.requires_grad:
        return FirDown2dFunction.apply(x, taps_h, taps_w)
    return fir_down2d(x, taps_h, taps_w)


# -------------------------------------------- fused bias + leaky ReLU ------
_FBA_LIBRARY = CudaLibrary("fused_bias_act.cu")
_FBA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bias_view(x: Tensor, bias: Tensor, channel_axis: int) -> Tensor:
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    return bias.float().reshape(shape)


def fused_bias_act_plain(x: Tensor, bias: Tensor, slope: float = 0.2,
                         scale: float = math.sqrt(2.0),
                         channel_axis: int = -1) -> Tensor:
    """Plain version of ``fba_fwd``: leaky_relu(x + bias, slope) * scale,
    the bias broadcast over ``channel_axis``; f32 arithmetic, one rounding
    to x's dtype (the kernel's)."""
    s = x.float() + _bias_view(x, bias, channel_axis)
    return (torch.where(s >= 0, s, slope * s) * scale).to(x.dtype)


def fused_bias_act_bwd_plain(x: Tensor, bias: Tensor, g: Tensor,
                             slope: float = 0.2,
                             scale: float = math.sqrt(2.0),
                             channel_axis: int = -1) -> Tensor:
    """Plain version of ``fba_bwd``: dx = g * (scale where x + bias >= 0,
    else slope * scale), the sign recomputed from x + bias."""
    s = x.float() + _bias_view(x, bias, channel_axis)
    d = torch.where(s >= 0, scale, float(np.float32(slope * scale)))
    return (g.float() * d).to(x.dtype)


def _fba_layout(x: Tensor, bias: Tensor, channel_axis: int,
                *others: Tensor) -> Tuple[int, int]:
    """Check what ``fused_bias_act.cu`` takes; return (inner, C)."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_bias_act needs a CUDA tensor, got {x.device}")
    if x.dtype not in _FBA_DTYPES:
        raise ValueError(f"fused_bias_act takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if x.ndim < 1:
        raise ValueError("fused_bias_act needs at least one axis")
    ax = channel_axis % x.ndim
    if ax not in (x.ndim - 1, 1):
        raise ValueError(f"fused_bias_act takes the channel axis last or at "
                         f"1, got axis {channel_axis} of {x.ndim}")
    c = x.shape[ax]
    if bias.shape != (c,) or bias.dtype != x.dtype or bias.device != x.device:
        raise ValueError(f"fused_bias_act needs a ({c},) {x.dtype} bias on "
                         f"{x.device}, got {tuple(bias.shape)} {bias.dtype} "
                         f"on {bias.device}")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("fused_bias_act: the gradient must match x's "
                             "shape, dtype and device")
    if not all(t.is_contiguous() for t in (x, bias) + others):
        raise ValueError(f"fused_bias_act takes contiguous tensors, got "
                         f"strides {x.stride()}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"fused_bias_act indexes with 32 bits: "
                         f"{x.numel()} elements")
    return math.prod(x.shape[ax + 1:]), c


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


class _FusedBiasActKernel:
    """Shared checks and launch of the two entry points of
    fused_bias_act.cu; ``entry`` names the one this wrapper launches."""

    entry = ""

    def __init__(self):
        self.library = _FBA_LIBRARY
        self.launches = 0
        self._fn = None

    def _launch(self, x: Tensor, bias: Tensor, g: Optional[Tensor],
                p0: float, p1: float, channel_axis: int) -> Tensor:
        grads = () if g is None else (g,)
        inner, c = _fba_layout(x, bias, channel_axis, *grads)
        out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        if self._fn is None:
            fn = getattr(self.library.load(), self.entry)
            fn.argtypes = ([ctypes.c_void_p] * (3 + len(grads))
                           + [ctypes.c_int] + [ctypes.c_int64] * 3
                           + [ctypes.c_float] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        ptrs = [t.data_ptr() for t in (x, bias, *grads, out)]
        with torch.cuda.device(x.device):
            err = self._fn(*ptrs, _FBA_DTYPES[x.dtype], x.numel(), inner, c,
                           p0, p1, _stream(x))
        if err != 0:
            raise RuntimeError(f"{self.entry} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out


class FusedBiasActFwd(_FusedBiasActKernel):
    """Wrapper of ``fba_fwd`` in ``csrc/fused_bias_act.cu``: leaky ReLU of
    x + bias, times scale, the bias on the last axis or axis 1.

    Replaces ditsep_tpu/ops/pallas_kernels.py:_fba_fwd_kernel (through
    fused_bias_act_pallas). f32 or bf16, contiguous, < 2^31 elements."""

    entry = "fba_fwd"

    def __call__(self, x: Tensor, bias: Tensor, slope: float = 0.2,
                 scale: float = math.sqrt(2.0),
                 channel_axis: int = -1) -> Tensor:
        return self._launch(x, bias, None, slope, scale, channel_axis)


class FusedBiasActBwd(_FusedBiasActKernel):
    """Wrapper of ``fba_bwd`` in ``csrc/fused_bias_act.cu``: dx of the
    fused bias-act from x, bias and the output gradient g (no mask).

    Replaces ditsep_tpu/ops/pallas_kernels.py:_fba_bwd_kernel (through
    _fba_bwd). Takes what ``FusedBiasActFwd`` takes; g like x."""

    entry = "fba_bwd"

    def __call__(self, x: Tensor, bias: Tensor, g: Tensor,
                 slope: float = 0.2, scale: float = math.sqrt(2.0),
                 channel_axis: int = -1) -> Tensor:
        # slope * scale rounds to f32 once, as in the plain version
        return self._launch(x, bias, g, scale, slope * scale, channel_axis)


fused_bias_act_fwd = FusedBiasActFwd()
fused_bias_act_bwd = FusedBiasActBwd()


class FusedBiasActFunction(torch.autograd.Function):
    """The fused bias-act with both passes as kernels (the counterpart of
    ``fused_bias_act_pallas``'s custom VJP). Saves x and bias, no mask;
    dbias = sum(dx) over all but the channel axis, in PyTorch, as the JAX
    package takes it outside its kernel. Not twice differentiable."""

    @staticmethod
    def forward(ctx, x, bias, slope, scale, channel_axis):
        ctx.save_for_backward(x, bias)
        ctx.args = (slope, scale, channel_axis)
        return fused_bias_act_fwd(x, bias, slope, scale, channel_axis)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        slope, scale, channel_axis = ctx.args
        dx = fused_bias_act_bwd(x, bias, g.contiguous(), slope, scale,
                                channel_axis)
        dbias = None
        if ctx.needs_input_grad[1]:
            ax = channel_axis % x.ndim
            dbias = dx.sum(tuple(d for d in range(x.ndim) if d != ax))
        return dx, dbias, None, None, None


# ------------------------------------- 3x3 conv, implicit GEMM, bordered ---
_CONV_LIBRARY = CudaLibrary("conv3x3.cu")
CONV_TILE = (8, 16)      # output rows x columns of an M tile (TH, TW)
CONV_SMEM_LIMIT = 232448  # shared memory a block can use on an H100
_CONV_KB = 64             # input channels a halo block (a ring stage's box)
_CONV_STAGE_BYTES = 23552  # one 64-channel halo stage (23,040 B) to 1 KiB
_CONV_WG_BLOCK_BYTES = 13312  # 9-tap: a warpgroup's 10 x 10 x 64 block to 1 KiB


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def conv3x3_smem_bytes(c: int, ns: int, is_async: bool) -> int:
    """Shared memory of one CTA of ``csrc/conv3x3.cu`` (its smem_layout),
    with K = C padded to kp, a multiple of 64: the 9 x kp x NS weight
    slice; two warpgroups' 10 x 10 halos of kp / 64 blocks (9-tap) or two
    64-channel TMA stages and four mbarriers (async); 128 x NS staging;
    1 KiB to align the base."""
    th, tw = CONV_TILE
    kp = _round_up(c, _CONV_KB)
    halo = (2 * _CONV_STAGE_BYTES if is_async
            else 2 * (kp // _CONV_KB) * _CONV_WG_BLOCK_BYTES)
    return (_round_up(9 * kp * ns * 2, 1024) + halo + th * tw * ns * 2
            + (32 if is_async else 0) + 1024)


def conv3x3_plan(c: int, c2: int, padw: int, is_async: bool, sms: int = 132,
                 n_tiles: Optional[int] = None) -> dict:
    """The launch plan of ``conv3x3_9tap`` / ``conv3x3_async_halo``.

    ``ns``: output channels a CTA keeps resident (64, or the widest of 32
    and 16 whose weights, halo and staging fit a block's shared memory; no
    wider than C2 needs); ``n_slices`` = ceil(C2 / ns); ``smem_bytes``;
    ``tile``: the M tile (rows, columns); ``threads``; ``ctas``: the
    persistent grid, the largest multiple of ``n_slices`` within ``sms``
    (so each CTA keeps one slice), at most one CTA an item when
    ``n_tiles`` M tiles are given. Raises ValueError for a shape the
    kernels do not take."""
    if c < 16 or c2 < 16 or c % 16 or c2 % 16:
        raise ValueError(f"conv3x3 takes C and C2 that are multiples of 16, "
                         f"got {c} and {c2}")
    if padw < 1 or (not is_async and padw != 1):
        raise ValueError(f"conv3x3: padw={padw} (9-tap: 1; async: >= 1)")
    ns = 64
    while ns > 16 and ns // 2 >= c2:
        ns //= 2
    while conv3x3_smem_bytes(c, ns, is_async) > CONV_SMEM_LIMIT:
        if ns == 16:
            raise ValueError(
                f"conv3x3 C={c}: the weights, halo and staging need "
                f"{conv3x3_smem_bytes(c, 16, is_async)} bytes of shared "
                f"memory even at 16 output channels a CTA, more than "
                f"{CONV_SMEM_LIMIT}")
        ns //= 2
    n_slices = -(-c2 // ns)
    ctas = n_slices * max(1, sms // n_slices)
    if n_tiles is not None:
        ctas = min(ctas, n_slices * n_tiles)
    return {"ns": ns, "n_slices": n_slices, "tile": CONV_TILE,
            "smem_bytes": conv3x3_smem_bytes(c, ns, is_async),
            "threads": 384 if is_async else 256, "ctas": ctas}


def conv3x3_bordered_plain(x: Tensor, w9: Tensor, padw: int = 1) -> Tensor:
    """Plain version of ``conv3x3_9tap`` / ``conv3x3_async_halo``.

    x (B, H+2, W+2*padw, C) with zero borders, w9 (9, C, C2) (tap
    ky*3+kx). The 9 shifted (B*H*W, C) @ (C, C2) products are accumulated
    in f32 and cast once to x's dtype; the output (B, H+2, W+2*padw, C2)
    has exact-zero borders (rows 0 and H+1, padw columns each side)."""
    b, hp, wp, _ = x.shape
    h, w = hp - 2, wp - 2 * padw
    xf, wf = x.float(), w9.float()
    acc = torch.zeros((b, h, w, w9.shape[2]), dtype=torch.float32,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            c0 = padw - 1 + kx
            acc += torch.matmul(xf[:, ky:ky + h, c0:c0 + w], wf[ky * 3 + kx])
    y = torch.zeros((b, hp, wp, w9.shape[2]), dtype=x.dtype, device=x.device)
    y[:, 1:1 + h, padw:padw + w] = acc.to(x.dtype)
    return y


class _Conv3x3Kernel:
    """Shared checks, plan and launch of the two entry points of
    conv3x3.cu (``library``: a variant build of it, for the ablation
    script)."""

    entry = ""
    is_async = False

    def __init__(self, library: Optional[CudaLibrary] = None):
        self.library = library or _CONV_LIBRARY
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(self.library.load(), self.entry)
            n_int = 8 if self.is_async else 7
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * n_int
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def plan(self, x: Tensor, w9: Tensor, padw: int) -> dict:
        """``conv3x3_plan`` for these tensors on their card."""
        b, hp, wp, c = x.shape
        tiles = (b * -(-(hp - 2) // CONV_TILE[0])
                 * -(-(wp - 2 * padw) // CONV_TILE[1]))
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        return conv3x3_plan(c, w9.shape[2], padw, self.is_async, sms, tiles)

    def _check(self, x: Tensor, w9: Tensor, padw: int) -> None:
        n = self.entry
        if x.device.type != "cuda" or w9.device != x.device:
            raise ValueError(f"{n} needs x and w9 on one CUDA device, got "
                             f"{x.device} and {w9.device}")
        if x.dtype != torch.bfloat16 or w9.dtype != torch.bfloat16:
            raise ValueError(f"{n} takes bfloat16, got {x.dtype} and "
                             f"{w9.dtype}")
        if x.ndim != 4 or w9.ndim != 3 or w9.shape[:2] != (9, x.shape[3]):
            raise ValueError(f"{n} takes x (B, Hp, Wp, C) and w9 (9, C, C2), "
                             f"got {tuple(x.shape)} and {tuple(w9.shape)}")
        b, hp, wp, c = x.shape
        c2 = w9.shape[2]
        if c % 16 or c2 % 16 or c == 0 or c2 == 0:
            raise ValueError(f"{n} takes C and C2 that are multiples of 16, "
                             f"got {c} and {c2}")
        if hp < 3 or padw < 1 or wp - 2 * padw < 1:
            raise ValueError(f"{n}: no interior in {tuple(x.shape)} with "
                             f"padw={padw}")
        if not (x.is_contiguous() and w9.is_contiguous()):
            raise ValueError(f"{n} takes contiguous tensors, got strides "
                             f"{x.stride()} and {w9.stride()}")
        if x.data_ptr() % 16 or w9.data_ptr() % 16:
            raise ValueError(f"{n} needs 16-byte aligned tensors")
        if b * hp * wp * max(c, c2) >= 2 ** 31:
            raise ValueError(f"{n}: {tuple(x.shape)} -> C2={c2} is too "
                             "large")

    def _launch(self, x: Tensor, w9: Tensor, padw: int,
                ctas: Optional[int]) -> Tensor:
        """Check, plan (``ctas``: another grid than the plan's, for the
        tests and the ablation's sweep) and launch."""
        self._check(x, w9, padw)
        plan = self.plan(x, w9, padw)
        if ctas is not None and ctas < 1:
            raise ValueError(f"{self.entry}: ctas must be >= 1, got {ctas}")
        fn = self._function()
        b, hp, wp, c = x.shape
        c2 = w9.shape[2]
        y = torch.empty((b, hp, wp, c2), dtype=x.dtype, device=x.device)
        pads = (padw,) if self.is_async else ()
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), w9.data_ptr(), y.data_ptr(), b, hp, wp, c,
                     c2, *pads, plan["ns"], ctas or plan["ctas"], _stream(x))
        if err != 0:  # 1 (invalid value): a shape or plan it does not take
            raise RuntimeError(f"{self.entry} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return y


class Conv3x3(_Conv3x3Kernel):
    """Wrapper of ``conv3x3_9tap`` in ``csrc/conv3x3.cu``: the bordered
    3x3 conv (padw 1); persistent CTAs keep a slice of the weights in
    shared memory, wgmma reads both operands by descriptor; each
    warpgroup loads its half of an M tile's halo with plain 16-byte
    loads.

    Replaces scripts/pallas_conv_probe.py:_conv_kernel (through
    conv3x3_pallas)."""

    entry = "conv3x3_9tap"

    def __call__(self, x: Tensor, w9: Tensor, padw: int = 1,
                 ctas: Optional[int] = None) -> Tensor:
        if padw != 1:
            raise ValueError(f"{self.entry} takes padw=1, got {padw}")
        return self._launch(x, w9, padw, ctas)


class Conv3x3AsyncHalo(_Conv3x3Kernel):
    """Wrapper of ``conv3x3_async_halo`` in ``csrc/conv3x3.cu``: the same
    conv on a layout with ``padw`` border columns a side; a producer
    warpgroup keeps TMA loads of the halo (64-channel blocks) in flight
    into an mbarrier ring while two warpgroups compute.

    Replaces scripts/pallas_conv_probe.py:_conv_dma_kernel (through
    conv3x3_pallas_dma)."""

    entry, is_async = "conv3x3_async_halo", True

    def __call__(self, x: Tensor, w9: Tensor, padw: int = 4,
                 ctas: Optional[int] = None) -> Tensor:
        return self._launch(x, w9, padw, ctas)


conv3x3_9tap = Conv3x3()
conv3x3_async_halo = Conv3x3AsyncHalo()
