"""Metrics and media logging of training: scalars as JSON lines,
``metrics.jsonl`` in the workdir, and, when the optional packages are
installed, TensorBoard (tensorboardX, under ``<workdir>/tb``) or wandb
(the port's ditsep_tpu/utils/logging.py:14-124).

Audio goes to TensorBoard as a summary proto built here (stdlib WAV
encoding, as the JAX package's: ``add_audio`` needs the soundfile
package); figures through ``add_figure`` (matplotlib). The wandb sink
has no test: wandb is not among the tests' packages.

Media must never stop a run, as in the JAX package; ``guarded`` runs a
media call under that rule and counts what it swallowed (``failures``),
so that a failing call is printed and shows in the run's result.
"""
from __future__ import annotations

import io
import json
import sys
import time
import traceback
import wave
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    """Writes scalars to a JSONL file and, when available, TensorBoard
    (``backend='tensorboard'``) or wandb (``backend='wandb'``); each sink
    is skipped where its package is not installed. ``enabled=False`` (the
    ranks but 0 of data-parallel training) makes every call a no-op."""

    def __init__(self, workdir: str, backend: str = "tensorboard",
                 project: Optional[str] = None, enabled: bool = True):
        self.enabled = enabled
        self.dir = Path(workdir)
        self.failures = 0
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if not enabled:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        if backend == "tensorboard":
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(str(self.dir / "tb"))
            except ImportError:
                pass
        elif backend == "wandb":
            try:
                import wandb
                self._wandb = wandb.init(project=project or "ditsep_tpu",
                                         dir=str(self.dir))
            except ImportError:
                pass

    def guarded(self, what: str, step: int, fn, *args, **kwargs) -> None:
        """``fn(*args, **kwargs)``; an exception is printed with its
        traceback and counted in ``failures``, and the run goes on."""
        try:
            fn(*args, **kwargs)
        except Exception as e:
            self.failures += 1
            print(f"[{what}] failed at step {step}: {e!r}\n"
                  f"{traceback.format_exc()}", file=sys.stderr, flush=True)

    def log_audio(self, tag: str, wav, step: int, fs: int = 8000) -> None:
        """A mono waveform, peak-normalized to 1 (non-finite samples set
        to 0 / +-1 first); nothing for an empty one."""
        if not self.enabled:
            return
        x = np.asarray(wav, np.float32).reshape(-1)
        if x.size == 0:
            return
        if not np.isfinite(x).all():
            x = np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
        peak = float(np.max(np.abs(x))) or 1.0
        x = x / max(peak, 1e-8)
        if self._tb is not None:
            from tensorboardX.proto.summary_pb2 import Summary
            audio = Summary.Audio(
                sample_rate=float(fs), num_channels=1,
                length_frames=len(x), encoded_audio_string=wav_bytes(x, fs),
                content_type="audio/wav")
            self._tb._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Audio(x, sample_rate=fs)}, step=step)

    def log_figure(self, tag: str, fig, step: int) -> None:
        """A matplotlib figure; closes it."""
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step, close=False)
        if self._wandb is not None:
            import wandb
            self._wandb.log({tag: wandb.Image(fig)}, step=step)
        import matplotlib.pyplot as plt
        plt.close(fig)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def wav_bytes(x: np.ndarray, fs: int) -> bytes:
    """A mono 16-bit WAV file of ``x`` (in [-1, 1]) as bytes."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()
