"""Scalar metrics of training as JSON lines, ``metrics.jsonl`` in the
workdir (the port's ditsep_tpu/utils/logging.py without TensorBoard, wandb
and media)."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    """Appends one ``{"step", "time", <metric>: value}`` line a call;
    ``enabled=False`` (the ranks but 0 of data-parallel training) writes
    nothing."""

    def __init__(self, workdir: str, enabled: bool = True):
        self.enabled = enabled
        self.dir = Path(workdir)
        self._jsonl = None
        if enabled:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.dir / "metrics.jsonl", "a")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
