"""Host-side work pools with the reference's push / pop API (port of
ditsep_tpu/utils/processing_pool.py).

The reference evaluates with torch.multiprocessing pools pinning one CUDA
device per worker (reference: src/utils/processing_pool.py:33-166). Here
the device work is batched in one process (``eval.evaluate``), so the
pool's remaining job is host-side metric computation: threads suffice
(numpy releases the GIL). The API mirrors the reference's.
"""
from __future__ import annotations

import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional


class ProcessingPool:
    """Async push/callback pool (reference: processing_pool.py:33-87)."""

    def __init__(self, num_workers: int = 4):
        self._pool = ThreadPoolExecutor(num_workers)
        self._futures: List[Future] = []
        self.errors: List[str] = []

    def push(self, fn: Callable, *args,
             callback: Optional[Callable] = None, **kwargs) -> Future:
        def wrapped():
            try:
                return fn(*args, **kwargs)
            except Exception:
                # collect worker errors with tracebacks and continue
                # (reference: processing_pool.py:55-60)
                self.errors.append(traceback.format_exc())
                return None

        fut = self._pool.submit(wrapped)
        if callback is not None:
            fut.add_done_callback(lambda f: callback(f.result()))
        self._futures.append(fut)
        return fut

    def join(self) -> List[Any]:
        out = [f.result() for f in self._futures]
        self._futures.clear()
        return out

    def close(self):
        self._pool.shutdown()


class SyncProcessingPool(ProcessingPool):
    """Ordered pop variant (reference: processing_pool.py:90-166)."""

    def pop(self) -> Any:
        if not self._futures:
            raise IndexError("pop from empty pool")
        fut = self._futures.pop(0)
        return fut.result()

    def __len__(self) -> int:
        return len(self._futures)
