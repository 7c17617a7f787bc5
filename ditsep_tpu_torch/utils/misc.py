"""Misc utilities mirroring the reference's utils package (port of
ditsep_tpu/utils/misc.py; reference: src/utils/stats.py,
src/utils/autoclip_module.py, src/utils/linalg.py, src/utils/split_dir.py,
src/utils/torch_utils.py)."""
from __future__ import annotations

import bisect
import dataclasses
from pathlib import Path
from typing import Dict, List, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

Tensor = torch.Tensor


def count_parameters(params: Union[nn.Module, Mapping[str, Tensor]]) -> int:
    """The number of parameters of a module, or of the tensors (or arrays)
    of a dict (reference: src/utils/torch_utils.py:4-7)."""
    leaves = (params.parameters() if isinstance(params, nn.Module)
              else params.values())
    return sum(int(np.prod(tuple(x.shape))) for x in leaves)


class StandardScaler:
    """Streaming Welford mean / variance normalizer (reference:
    src/utils/stats.py:4-89). Host-side numpy float64 state; ``transform``
    and ``inverse_transform`` take tensors and compute in their dtype."""

    def __init__(self, dim: int):
        self.count = 0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def update(self, x) -> None:
        if isinstance(x, Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float64).reshape(-1, self.mean.shape[0])
        for row in x:
            self.count += 1
            delta = row - self.mean
            self.mean += delta / self.count
            self.m2 += delta * (row - self.mean)

    @property
    def var(self) -> np.ndarray:
        return self.m2 / max(self.count - 1, 1)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.var)

    def _t(self, a: np.ndarray, x: Tensor) -> Tensor:
        return torch.as_tensor(a).to(device=x.device, dtype=x.dtype)

    def transform(self, x: Tensor) -> Tensor:
        return (x - self._t(self.mean, x)) / self._t(
            np.maximum(self.std, 1e-8), x)

    def inverse_transform(self, x: Tensor) -> Tensor:
        return x * self._t(self.std, x) + self._t(self.mean, x)


class AutoClipper:
    """Percentile-history gradient clipping (reference:
    src/utils/autoclip_module.py:33-70). The host keeps the norm history;
    ``threshold(gnorm)`` takes this step's global norm and returns the
    clip value (e.g. for ``clip_update_by_threshold``)."""

    def __init__(self, p: float):
        self.autoclip_p = p / 100.0
        self.grad_norm_history: List[float] = []

    def threshold(self, gnorm: float) -> float:
        bisect.insort(self.grad_norm_history, float(gnorm))
        index = int(self.autoclip_p * len(self.grad_norm_history))
        if index == len(self.grad_norm_history):
            index -= 1
        return self.grad_norm_history[index]


def clip_update_by_threshold(updates: Mapping[str, Tensor],
                             gnorm: Union[Tensor, float],
                             threshold: float) -> Dict[str, Tensor]:
    """A dict of gradient or update tensors scaled to the norm
    ``threshold``: each times min(1, threshold / max(gnorm, 1e-12))."""
    gnorm = torch.as_tensor(gnorm, dtype=torch.float32)
    scale = torch.clamp(threshold / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: u * scale.to(device=u.device, dtype=u.dtype)
            for k, u in updates.items()}


def solve_psd_loaded(a: Tensor, b: Tensor, load: float = 1e-5) -> Tensor:
    """Diagonally loaded PSD solve, a + load trace(a) / n I (reference:
    src/utils/linalg.py:20-36)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    trace = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return torch.linalg.solve(a + load * trace / n * eye, b)


@dataclasses.dataclass
class SplitDirectory:
    """Rolling output sharding, at most ``max_files`` files a
    subdirectory (reference: src/utils/split_dir.py:5-47)."""

    root: str
    max_files: int = 1000

    def __post_init__(self):
        self._count = 0
        self._shard = 0
        Path(self.root).mkdir(parents=True, exist_ok=True)

    def next_path(self, filename: str) -> str:
        if self._count >= self.max_files:
            self._shard += 1
            self._count = 0
        d = Path(self.root) / f"{self._shard:05d}"
        d.mkdir(parents=True, exist_ok=True)
        self._count += 1
        return str(d / filename)
