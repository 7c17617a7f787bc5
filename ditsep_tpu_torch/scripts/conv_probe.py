"""3x3-conv probe at the sampler's dominant conv, on one CUDA card.

Port of scripts/pallas_conv_probe.py: the U-Net's full-resolution conv
(576x256 spatial, 128 -> 128 channels, bf16) as the two hand-written
implicit-GEMM kernels of ``csrc/conv3x3.cu`` on their zero-bordered NHWC
layouts, against cuDNN's conv (``F.conv2d``, channels_last, padding 1) as
the yardstick; the port never calls cuDNN for this op.

    python -m ditsep_tpu_torch.scripts.conv_probe [--batch 16] [--stack 30]
                                                  [--reps 5]

1. Parity at batch 1: both kernels against the plain version (1 bf16 ulp
   of max|ref|), the plain version in f32 against ``F.conv2d`` in f32 (TF32
   off) on the same weights (1e-5 of max|ref|), output borders exactly 0.
2. Timing: chained stacks of ``--stack`` convs (the layout is closed under
   the op), ``--reps`` stacks between CUDA events after one warm stack.

It prints one JSON line per phase and per timed row (``ms_per_conv``,
``tflops``, ``pct_peak``, ``bound_ms``) and writes no file. Tests call
``parity(..., device="cpu")`` at a small shape, where the public functions
take the plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ditsep_tpu_torch.ops.conv3x3 import (
    conv3x3_bordered, conv3x3_bordered_async,
)
from ditsep_tpu_torch.ops.cuda_kernels import bf16_ulp, conv3x3_bordered_plain
from ditsep_tpu_torch.utils.device import card_line, card_peaks, resolve_device

H, W, C, C2 = 576, 256, 128, 128
PADW = 4  # border columns a side of the async-halo layout


def conv_flops(b: int, h: int, w: int, c: int, c2: int) -> float:
    return 2.0 * b * h * w * c * c2 * 9


def make_inputs(b, h, w, c, c2, seed, device):
    """The probe's inputs from a numpy seed: interior x * 0.1 (B, H, W, C)
    and w9 * 0.05 (9, C, C2), bf16; the interior bordered by 1 and by
    PADW columns."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(0.1 * rng.standard_normal((b, h, w, c), np.float32))
    w9 = torch.from_numpy(0.05 * rng.standard_normal((9, c, c2), np.float32))
    x = x.to(device=device, dtype=torch.bfloat16)
    w9 = w9.to(device=device, dtype=torch.bfloat16)
    x1 = F.pad(x, (0, 0, 1, 1, 1, 1))
    x4 = F.pad(x, (0, 0, PADW, PADW, 1, 1))
    return x, x1, x4, w9


def border_max(y: torch.Tensor, padw: int) -> float:
    parts = (y[:, :1], y[:, -1:], y[:, :, :padw], y[:, :, -padw:])
    return max(p.float().abs().max().item() for p in parts)


def parity(b=1, h=H, w=W, c=C, c2=C2, device="cuda", seed=0) -> dict:
    """Both bordered convs against the plain version, and the plain
    version against F.conv2d in f32; raises on a failed check."""
    x, x1, x4, w9 = make_inputs(b, h, w, c, c2, seed, device)
    ref = conv3x3_bordered_plain(x1, w9, 1)
    got = conv3x3_bordered(x1, w9)
    got4 = conv3x3_bordered_async(x4, w9, PADW)
    peak = ref.float().abs().max().item()
    tol = float(bf16_ulp(peak))
    err = (got.float() - ref.float()).abs().max().item()
    err4 = (got4[:, :, PADW - 1:-(PADW - 1)].float()
            - ref.float()).abs().max().item()
    borders = (border_max(got, 1), border_max(got4, PADW))
    # the plain version in f32 against the library conv in f32
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = F.conv2d(x.float().permute(0, 3, 1, 2),
                        w9.float().reshape(3, 3, c, c2).permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    plain32 = conv3x3_bordered_plain(x1.float(), w9.float(), 1)
    err32 = (plain32[:, 1:-1, 1:-1] - want).abs().max().item()
    tol32 = 1e-5 * want.abs().max().item()
    out = {"phase": "parity", "shape": [b, h, w, c, c2], "device": str(device),
           "max_abs_err_9tap": err, "max_abs_err_async_halo": err4,
           "bf16_tolerance": tol, "border_max": max(borders),
           "plain_f32_vs_conv2d": err32, "f32_tolerance": tol32}
    for name, e, t in (("9tap", err, tol), ("async_halo", err4, tol),
                       ("plain f32 vs F.conv2d", err32, tol32)):
        if not e <= t:
            raise RuntimeError(f"conv probe parity: {name} error {e} > {t}")
    if max(borders) != 0.0:
        raise RuntimeError(f"conv probe: nonzero output border {borders}")
    return out


def _stack_ms(step, h0, stack: int, reps: int) -> float:
    """Device ms per conv of ``stack`` chained calls, by CUDA events."""
    def run():
        h = h0
        for _ in range(stack):
            h = step(h)
        return h
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * stack)


def time_rows(batch: int = 16, stack: int = 30, reps: int = 5,
              seed: int = 0) -> list:
    """The probe's three timed rows on the card, each a dict."""
    name = torch.cuda.get_device_name(0)
    peak, bandwidth = card_peaks(name)
    x, x1, x4, w9 = make_inputs(batch, H, W, C, C2, seed, "cuda")
    w_oihw = (w9.reshape(3, 3, C, C2).permute(3, 2, 0, 1)
              .contiguous(memory_format=torch.channels_last))
    flops = conv_flops(batch, H, W, C, C2)
    rows = []
    for variant, step, h0, width in (
            ("cudnn_native", lambda h: F.conv2d(h, w_oihw, padding=1),
             x.permute(0, 3, 1, 2), W),
            ("cuda_9tap", lambda h: conv3x3_bordered(h, w9), x1, W + 2),
            ("cuda_async_halo",
             lambda h: conv3x3_bordered_async(h, w9, PADW), x4,
             W + 2 * PADW)):
        rows_in = H if variant == "cudnn_native" else H + 2
        nbytes = batch * rows_in * width * (C + C2) * 2 + w9.numel() * 2
        ms = _stack_ms(step, h0, stack, reps)
        tflops = flops / (ms * 1e-3) / 1e12
        rows.append({"variant": variant, "batch": batch, "stack": stack,
                     "reps": reps, "ms_per_conv": ms, "tflops": tflops,
                     "pct_peak": 100 * tflops * 1e12 / peak,
                     "bound_ms": max(flops / peak, nbytes / bandwidth) * 1e3,
                     "bound_by": ("operations" if flops / peak
                                  >= nbytes / bandwidth else "bytes")})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--stack", type=int, default=30)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    card = card_line()
    print(json.dumps({"phase": "device", "card": card,
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "shape": [H, W, C, C2], "batch": args.batch,
                      "stack": args.stack}), flush=True)
    checks = parity(device="cuda", seed=args.seed)
    print(json.dumps({**checks, "card": card}), flush=True)
    rows = time_rows(args.batch, args.stack, args.reps, args.seed)
    for row in rows:
        print(json.dumps({**row, "card": card}), flush=True)
    return {"card": card, "parity": checks, "rows": rows}


if __name__ == "__main__":
    main(sys.argv[1:])
