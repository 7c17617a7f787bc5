"""Where the time of the conv kernels goes, on one CUDA card.

The card's machine has no kernel profiler (ncu, nsys), so this script
takes the kernels apart instead:

1. Ablation: it builds variants of ``ditsep_tpu_torch/csrc/conv3x3.cu``
   (``CudaLibrary`` with source edits), each with one part of the work cut
   out, and times every variant's two entry points at the conv probe's
   shape. The variants compute wrong results by design; they are timed,
   never used. The difference between ``base`` and a variant is the time
   that part costs where it cannot hide behind the rest.
2. Sweep: both kernels of the real build with several persistent grids
   (CTA counts), at ``--batch`` and at batch 1. Every output must equal
   the one of the plan's own grid bit for bit (a CTA computes each of its
   items whole, in a fixed order); grids that are not a multiple of the
   slice count make CTAs change slice, which reloads their weights.

    python -m ditsep_tpu_torch.scripts.conv_ablation [--batch 16] [--reps 10]

Variants:
  base         the source as it is;
  no_mma       no wgmma (the halo still arrives, stage by stage);
  no_wload     no weight reads from device memory (the one-time load's
               shared-memory stores stay);
  no_halo      no input reads: the 9-tap kernel's halo loads land zeros,
               the async kernel's producer issues no TMA (it completes
               the stage's barrier itself);
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
    Conv3x3, Conv3x3AsyncHalo, CudaLibrary, conv3x3_9tap, conv3x3_async_halo,
)
from ditsep_tpu_torch.scripts.conv_probe import (
    C, C2, H, PADW, W, conv_flops, make_inputs,
)
from ditsep_tpu_torch.utils.device import card_line, card_peaks, resolve_device

# variant -> (text in conv3x3.cu, replacement); CudaLibrary raises if a
# text is missing, so a stale edit cannot time the unchanged kernel
EDITS = {
    "base": [],
    "no_mma": [("wgmma_ss<NS>(acc, a_desc<PITCH>(",
                "if (kb < 0) wgmma_ss<NS>(acc, a_desc<PITCH>(")],
    "no_wload": [("if (col < p.c2 && k < p.c)", "if (col < 0 && k < p.c)")],
    "no_halo": [("if (idx < WG_PIX * 8 && pr < p.hp",
                 "if (idx < 0 && pr < p.hp"),
                ("mbar_arrive_tx(full, STAGE_TX);", "mbar_arrive(full);"),
                ("tma_load_4d(sbase + p.halo_off",
                 "if (n > (1u << 31)) tma_load_4d(sbase + p.halo_off")],
    "no_store": [("if (i < p.h && j < p.w_out && n < p.c2)",
                  "if (i < 0 && j < p.w_out && n < p.c2)")],
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
    _, x1, x4, w9 = make_inputs(batch, H, W, C, C2, 1, "cuda")
    for kernel, xb, padw in ((conv3x3_9tap, x1, 1),
                             (conv3x3_async_halo, x4, PADW)):
        plan = kernel.plan(xb, w9, padw)
        want = kernel(xb, w9, padw)
        for ctas in sorted({2, 7, plan["ctas"] // 2, plan["ctas"] - 1,
                            plan["ctas"], 2 * plan["ctas"]}):
            got = kernel(xb, w9, padw, ctas=ctas)
            if not torch.equal(got, want):
                raise RuntimeError(f"{kernel.entry}: ctas={ctas} differs "
                                   f"from the plan's {plan['ctas']}")
            ms = device_ms(lambda: kernel(xb, w9, padw, ctas=ctas),
                           1 if ctas < 16 else reps)
            out.append({"sweep": "ctas", "entry": kernel.entry,
                        "batch": batch, "ctas": ctas,
                        "chosen": ctas == plan["ctas"], "ms": ms,
                        "card": card})
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
