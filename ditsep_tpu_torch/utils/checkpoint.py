"""Checkpoints of training: top-k on a monitored metric, a rolling latest,
a best-model link and an index (the port's ditsep_tpu/utils/checkpoint.py
:30-170 on ``torch.save``; orbax is not ported).

A checkpoint is a directory holding ``state.pt`` (the state's
``state_dict()``: a TrainState's step, model, optimizer and EMA, or the
LDM's and VAE-GAN's states) beside ``metrics.json`` (top-k) or
``step.json`` (latest).
"""
from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    """Top-k checkpoint manager keyed by the metric ``monitor``, the
    highest first (``mode`` 'max') or the lowest ('min'); NaN or missing
    metrics rank worst. The states saved and restored are any objects
    with ``state_dict`` / ``load_state_dict``. ``write=False`` (the ranks
    but 0 of data-parallel training) keeps ``restore`` and makes every
    write a no-op, so that the ranks do not race the shared files."""

    def __init__(self, directory: str, monitor: str = "val/si_sdr",
                 mode: str = "max", save_top_k: int = 20,
                 write: bool = True):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', not {mode!r}")
        self.monitor, self.mode, self.save_top_k = monitor, mode, save_top_k
        self.write = write
        self.dir = Path(directory)
        if write:
            self.dir.mkdir(parents=True, exist_ok=True)
        self._index_path = self.dir / "index.json"
        self._index: Dict[str, float] = {}
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    def _ranked(self):
        """(name, metric) pairs, the best first."""
        sign = 1.0 if self.mode == "max" else -1.0
        return sorted(self._index.items(),
                      key=lambda kv: (-math.inf if math.isnan(kv[1])
                                      else sign * kv[1]),
                      reverse=True)

    def _ckpt_name(self, step: int, metric: float) -> str:
        key = self.monitor.replace("/", "_")
        return f"step-{step:08d}_{key}-{metric:.3f}"

    def save(self, state, step: int, metrics: Dict[str, float]) -> str:
        """Save ``state``; prune to top-k; refresh the best link."""
        if not self.write:
            return ""
        metric = float(metrics.get(self.monitor, float("nan")))
        name = self._ckpt_name(step, metric)
        path = self.dir / name
        path.mkdir(parents=True, exist_ok=True)
        torch.save(state.state_dict(), path / STATE_FILE)
        (path / "metrics.json").write_text(json.dumps(
            {k: float(v) for k, v in metrics.items()}, indent=1))
        self._index[name] = metric
        for old, _ in self._ranked()[self.save_top_k:]:
            if (self.dir / old).exists():
                shutil.rmtree(self.dir / old)
            self._index.pop(old, None)
        self._index_path.write_text(json.dumps(self._index, indent=1))
        link, tmp = self.dir / "best-model", self.dir / ".best-model.tmp"
        if tmp.exists() or tmp.is_symlink():
            tmp.unlink()
        os.symlink(self._ranked()[0][0], tmp)
        os.replace(tmp, link)
        return str(path)

    def save_latest(self, state, step: int) -> str:
        """Write (or replace) the rolling 'latest' checkpoint, the resume
        anchor, with no moment where none exists."""
        if not self.write:
            return ""
        tmp, final, old = (self.dir / ".latest.tmp", self.dir / "latest",
                           self.dir / ".latest.old")
        for p in (tmp, old):
            if p.exists():
                shutil.rmtree(p)
        tmp.mkdir()
        torch.save(state.state_dict(), tmp / STATE_FILE)
        (tmp / "step.json").write_text(json.dumps({"step": int(step)}))
        if final.exists():
            os.replace(final, old)
        os.replace(tmp, final)
        if old.exists():
            shutil.rmtree(old)
        return str(final)

    def best_path(self) -> Optional[str]:
        link = self.dir / "best-model"
        return str(link.resolve()) if link.exists() else None

    def latest_path(self) -> Optional[str]:
        """The rolling 'latest' checkpoint if present, else the newest
        retained top-k one."""
        if (self.dir / "latest").exists():
            return str(self.dir / "latest")
        if not self._index:
            return None
        return str(self.dir / sorted(self._index)[-1])

    def restore(self, state, path: Optional[str] = None,
                prefer: str = "latest"):
        """Load a checkpoint into ``state`` (its tensors stay on their
        devices: the file is read to the CPU and copied in) and return
        it. ``prefer='latest'`` resumes where training stopped, 'best'
        takes the top-metric checkpoint."""
        if path is None:
            first, second = ((self.latest_path, self.best_path)
                             if prefer == "latest"
                             else (self.best_path, self.latest_path))
            path = first() or second()
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        state.load_state_dict(torch.load(Path(path) / STATE_FILE,
                                         map_location="cpu"))
        return state
