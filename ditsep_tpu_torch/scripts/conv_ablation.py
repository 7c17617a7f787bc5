"""Where the time of the conv kernels goes, on one CUDA card.

The card's machine has no kernel profiler (ncu, nsys), so this script
takes the kernels apart instead:

1. Ablation: it builds variants of ``ditsep_tpu_torch/csrc/conv3x3.cu``
   (``CudaLibrary`` with source edits), each with one part of the work cut
   out, and times every variant's two entry points at the conv probe's
   shape. The variants compute wrong results by design; they are timed,
   never used. The difference between ``base`` and a variant is the time
   that part costs where it cannot hide behind the rest.
2. Sweep: ``conv3x3_async_halo`` of the real build with each number of
   row tiles a block walks, at ``--batch`` and at batch 1. Every output
   must equal the one of the wrapper's own choice bit for bit (the
   arithmetic of a tile does not depend on the walk), which checks the
   double buffer's wrap at every length.

    python -m ditsep_tpu_torch.scripts.conv_ablation [--batch 16] [--reps 10]

Variants:
  base         the source as it is;
  no_mma       no tensor-core products (the fragment loads stay);
  no_wload     no weight loads from device memory (the smem stores stay);
  no_halo      no input reads (zeros land in the halo tile);
  no_store     no output stores (the staging tile stays).
It prints one JSON line per variant and entry point, then one per sweep
point.
"""
from __future__ import annotations

import argparse
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from ditsep_tpu_torch.ops.cuda_kernels import (
    CONV_TILE, Conv3x3, Conv3x3AsyncHalo, CudaLibrary, conv3x3_async_halo,
)
from ditsep_tpu_torch.scripts.conv_probe import (
    C, C2, H, PADW, W, conv_flops, make_inputs,
)
from ditsep_tpu_torch.utils.device import card_line, card_peaks, resolve_device

# variant -> (text in conv3x3.cu, replacement); CudaLibrary raises if a
# text is missing, so a stale edit cannot time the unchanged kernel
EDITS = {
    "base": [],
    "no_mma": [("mma_16816(acc[mi][2 * jp], a[mi], b[0], b[1]);",
                "if (kk < 0) mma_16816(acc[mi][2 * jp], a[mi], b[0], b[1]);"),
               ("mma_16816(acc[mi][2 * jp + 1], a[mi], b[2], b[3]);",
                "if (kk < 0) mma_16816(acc[mi][2 * jp + 1], a[mi], b[2], "
                "b[3]);")],
    "no_wload": [("regs[r] = *reinterpret_cast<const uint4*>(",
                  "regs[r] = make_uint4(idx, 0, 0, 0);\n"
                  "      if (idx < 0) regs[r] = "
                  "*reinterpret_cast<const uint4*>(")],
    "no_halo": [("if (valid) v = *reinterpret_cast<const uint4*>(src);", ""),
                ("cp_async16(dst, src, valid);",
                 "cp_async16(dst, src, false);")],
    "no_store": [("if (i < p.h && j < p.w_out && n < nc)",
                  "if (i < 0 && j < p.w_out && n < nc)")],
}


def device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one, by events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ablation(batch: int, reps: int, card: str) -> list:
    libs = {name: CudaLibrary("conv3x3.cu", edits) for name, edits
            in EDITS.items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs.values()))
    _, x1, x4, w9 = make_inputs(batch, H, W, C, C2, 0, "cuda")
    peak = card_peaks(torch.cuda.get_device_name(0))[0]
    flops = conv_flops(batch, H, W, C, C2)
    out = []
    for name, lib in libs.items():
        for kernel, xb in ((Conv3x3(lib), x1), (Conv3x3AsyncHalo(lib), x4)):
            ms = device_ms(lambda: kernel(xb, w9, 1 if xb is x1 else PADW),
                           reps)
            out.append({"variant": name, "entry": kernel.entry,
                        "batch": batch, "ms": ms,
                        "pct_peak": 100 * flops / (ms * 1e-3) / peak,
                        "card": card})
            print(json.dumps(out[-1]), flush=True)
    return out


def sweep(batch: int, reps: int, card: str) -> list:
    out = []
    _, _, x4, w9 = make_inputs(batch, H, W, C, C2, 1, "cuda")
    chosen = conv3x3_async_halo.rows_per_block(x4, PADW)
    want = conv3x3_async_halo(x4, w9, PADW)
    row_tiles = -(-H // CONV_TILE[0])
    for rows in sorted({1, 2, 3, 4, 6, 9, 12, 18, row_tiles, chosen}):
        got = conv3x3_async_halo(x4, w9, PADW, rows_per_block=rows)
        if not torch.equal(got, want):
            raise RuntimeError(f"conv3x3_async_halo: rows_per_block={rows} "
                               f"differs from rows_per_block={chosen}")
        ms = device_ms(lambda: conv3x3_async_halo(
            x4, w9, PADW, rows_per_block=rows), reps)
        out.append({"sweep": "rows_per_block", "batch": batch,
                    "rows_per_block": rows, "chosen": rows == chosen,
                    "ms": ms, "card": card})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    card = card_line()
    out = ablation(args.batch, args.reps, card)
    for batch in sorted({args.batch, 1}, reverse=True):
        out += sweep(batch, args.reps, card)
    return out


if __name__ == "__main__":
    main()
