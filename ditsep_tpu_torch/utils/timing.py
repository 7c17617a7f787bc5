"""Timing of a call on the CUDA card, as a caller sees it."""
from __future__ import annotations

import torch


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one of ``iters`` back-to-back calls of ``fn``, by CUDA
    events: host overhead included where the host is slower than the
    card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
