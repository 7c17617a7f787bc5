"""Profiling, tracing and numerical-debug hooks (port of
ditsep_tpu/utils/profiling.py).

Replaces the reference's minimal instrumentation (reference: the
hand-rolled Profiler ticker src/stable_audio_tools/training/
diffusion.py:28-43, wall-clock eval timing src/evaluate_mp.py:325-327,
detect_anomaly=True src/train_diffsep.py:160) with ``torch.profiler``
traces and explicit finite checks.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (the CPU, and the card when CUDA is available)
    and write a Chrome trace, ``trace_<pid>_<ns>.json``, into ``log_dir``
    (viewable in Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named trace region (shows in the profiler's timeline)."""
    return torch.profiler.record_function(name)


class Ticker:
    """Wall-clock phase ticker (reference: training/diffusion.py:28-43)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, float] = {}
        self._last = time.perf_counter()

    def tick(self, name: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + now - self._last
        self._last = now

    def summary(self) -> Dict[str, float]:
        return dict(self.times)


def enable_nan_debugging() -> None:
    """Autograd's anomaly detection, the detect_anomaly=True equivalent:
    a backward that makes a NaN raises, naming its forward op. Slows
    everything down; an escape hatch only."""
    torch.autograd.set_detect_anomaly(True)


def _leaves(tree: Any, path=()):
    """(path, leaf) of nested dicts, lists and tuples in JAX's order (a
    dict's keys sorted) and by JAX's names (a key as it is, an index as
    ``[i]``); None is no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise if any leaf (a tensor, an array or a number, in nested dicts,
    lists and tuples) holds a non-finite value; the message names the
    leaf's path, ``name:a/b``. Synchronizes with the card."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().cpu().numpy()
        a = np.asarray(leaf)
        if not np.all(np.isfinite(a)):
            p = "/".join(str(k) for k in path)
            raise FloatingPointError(
                f"non-finite values in {name}:{p} "
                f"(nan={np.isnan(a).sum()}, inf={np.isinf(a).sum()})")


def finite_guard(metrics: Dict[str, Any]) -> bool:
    """A cheap per-step guard: True if every scalar metric is finite."""
    return all(np.isfinite(float(v)) for v in metrics.values())
