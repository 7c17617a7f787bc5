"""Dynamic-batching separation engine (port of ditsep_tpu/serving/engine.py).

Design:

- Bounded shapes. Every dispatched batch has shape ``(batch_size, 1,
  bucket_len)`` drawn from a bounded grid: bucket lengths follow the score
  model's 64-frame STFT blocks (the frame-block buckets of
  ``eval/evaluate.py:_bucket_lengths_frames``, docs/pad_dilution_r03.md),
  or multiples of ``bucket_multiple`` samples (the latent path), and batch
  sizes are powers of two up to ``max_batch`` (on a mesh of n cards, n
  times powers of two, the cap rounded up to a multiple of n). cuDNN
  meets a bounded set of shapes, each of which ``warmup`` can visit
  before traffic.
- One dispatch thread owns the device and the engine's
  ``torch.Generator``: requests are host objects until their batch is
  uploaded, and every batch draws its noise from the one generator, in
  dispatch order.
- Grouping policy: serve the bucket holding the OLDEST request; dispatch
  early when ``max_batch`` requests of that bucket wait, else after
  ``max_wait_ms``. Under load the engine converges to full batches; at
  low load latency is bounded by one sampler call plus ``max_wait_ms``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ditsep_tpu_torch.ops.stft import frame_block_padded_len as _padded_len
from ditsep_tpu_torch.parallel import sharded
from ditsep_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


def frame_block_padded_len(length: int, frame_spec: Tuple[int, int, int]
                           ) -> int:
    """The engine's bucket for ``length`` samples under ``frame_spec`` =
    ``(n_fft, hop, block)``: the largest length inside the same
    ``block``-frame block (``ops/stft.py``), so bucket padding adds no
    quiet columns through the U-Net."""
    n_fft, hop, block = frame_spec
    return _padded_len(length, n_fft, hop, block)


@dataclass
class _Request:
    audio: np.ndarray          # (T,) float32
    bucket: int                # padded length
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)


class BatchingEngine:
    """Groups concurrent separation requests into bounded-shape batches.

    Parameters
    ----------
    separate_fn:
        ``separate_fn(mix, lengths=None, generator=g) -> est``: ``mix`` is
        a (B, 1, T) float32 tensor on ``device``, ``est`` a (B, n_src, T)
        tensor (or array), ``g`` the engine's generator, e.g.
        ``lambda mix, lengths=None, generator=None: trainer.separate(mix,
        generator=generator)[0]``. With ``pass_lengths`` the call gets
        ``lengths``, (B,) int64 on ``device``, each item's valid samples,
        for mask_padding score models (padding then costs nothing even
        across frame blocks).
    frame_spec:
        ``(n_fft, hop, block)`` of the score model's STFT for frame-block
        buckets, or None to bucket by ``bucket_multiple`` samples (the
        latent path).
    mesh:
        ``parallel.make_mesh()`` of this process's cards: each batch is
        split over them, a replica of the separator on each
        (``separate_fn.replicate(device)``, as ``TrainerSeparator``
        has), each replica drawing its rows of the whole batch's draws,
        and the stems are concatenated. A mesh of one card is the plain
        engine, bit for bit.
    seed:
        seeds the engine's generator on ``device``.
    wire_int16:
        move audio host <-> device as int16 (the 16-bit quantization a WAV
        response carries anyway; inputs are clipped to [-1, 1]): half the
        transfer bytes. The host quantizes with x 32768; the device
        dequantizes (/ 32768) before ``separate_fn`` and requantizes its
        estimates (round(clip x 32767)); the host divides by 32767, as
        the JAX engine does.
    pipeline_depth:
        batches in flight at once. With depth >= 2 the dispatch thread
        uploads and runs batch k+1 while a completion thread copies batch
        k's estimates to the host and resolves its futures; the semaphore
        bounding them is taken before the upload. depth 1 runs upload,
        separation and download in turn on the dispatch thread. Results
        and the generator's stream are the same at any depth (draws are
        made in dispatch order).
    device:
        where batches run; the CUDA card unless ``"cpu"`` is given.
    """

    def __init__(self, separate_fn, *, fs: int = 8000, max_batch: int = 8,
                 max_wait_ms: float = 50.0,
                 frame_spec: Optional[Tuple[int, int, int]] = (510, 128, 64),
                 bucket_multiple: int = 4096,
                 max_seconds: float = 60.0,
                 pass_lengths: bool = False,
                 mesh=None, seed: int = 0,
                 wire_int16: bool = False,
                 pipeline_depth: int = 2,
                 device="cuda"):
        n_dev = 1
        self._replicas = None
        if mesh is not None:
            if mesh.world_size > 1:
                raise ValueError("the engine splits batches over the cards "
                                 "of one process; got a mesh of "
                                 f"{mesh.world_size} processes")
            device, n_dev = mesh.device, mesh.devices.size
            if n_dev > 1:
                self._replicas = [separate_fn] + [
                    separate_fn.replicate(d) for d in mesh.local[1:n_dev]]
        self.mesh = mesh
        self.device = resolve_device(device)
        self.separate_fn = separate_fn
        self.wire_int16 = bool(wire_int16)
        self.fs = int(fs)
        self.max_wait = max_wait_ms / 1e3
        self.frame_spec = frame_spec
        self.bucket_multiple = int(bucket_multiple)
        self.max_len = int(max_seconds * fs)
        self.pass_lengths = bool(pass_lengths)
        # allowed batch sizes: the device count times powers of two below
        # max_batch, and the cap rounded up to a multiple of the device
        # count (every batch splits over the cards)
        sizes, b = [], n_dev
        while b < max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(-(-max(max_batch, n_dev) // n_dev) * n_dev)
        self.batch_sizes = sorted(set(sizes))
        self.max_batch = self.batch_sizes[-1]

        self._generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self._pool = None
        if self._replicas is not None:
            self._replica_generators = [torch.Generator(device=d)
                                        for d in mesh.local[:n_dev]]
            self._pool = ThreadPoolExecutor(n_dev,
                                            thread_name_prefix="ditsep-rep")
        # one sampler call at a time: warmup() runs on the caller's thread
        self._device_lock = threading.Lock()
        self._pending: Dict[int, List[_Request]] = {}
        self._cv = threading.Condition()
        self._closed = False
        self._stats = {"requests": 0, "batches": 0, "batched_items": 0,
                       "padded_rows": 0, "rejected": 0}
        self._latencies: List[float] = []
        self._queue = None
        self._completion_thread = None
        self._inflight_sem = None
        self._inflight: Dict[int, List[_Request]] = {}
        if int(pipeline_depth) > 1:
            import queue

            # the semaphore is acquired BEFORE a batch is uploaded and
            # released after its host copy completes, so dispatched-but-
            # unread batches are bounded by pipeline_depth exactly (a
            # bounded queue alone would admit one extra: the producer
            # would block in put() holding an already-dispatched batch)
            self._inflight_sem = threading.Semaphore(int(pipeline_depth))
            self._queue = queue.Queue()
            self._completion_thread = threading.Thread(
                target=self._completion_loop, daemon=True,
                name="ditsep-completer")
            self._completion_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ditsep-batcher")
        self._thread.start()

    # ------------------------------------------------------------- public
    def bucket_of(self, length: int) -> int:
        if self.frame_spec is not None:
            return frame_block_padded_len(length, self.frame_spec)
        m = self.bucket_multiple
        return -(-length // m) * m

    def submit(self, audio: np.ndarray) -> Future:
        """Enqueue one mono utterance ((T,) or (1,T)); returns a Future
        resolving to (n_src, T) float32 trimmed to the input length."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 2 and audio.shape[0] == 1:
            audio = audio[0]
        if audio.ndim != 1:
            raise ValueError(f"expected mono (T,) audio, got {audio.shape}")
        req = _Request(audio=audio, bucket=self.bucket_of(audio.shape[-1]))
        if audio.shape[-1] == 0 or audio.shape[-1] > self.max_len:
            with self._cv:
                self._stats["rejected"] += 1
            req.future.set_exception(ValueError(
                f"utterance length {audio.shape[-1]} outside "
                f"(0, {self.max_len}] samples"))
            return req.future
        with self._cv:
            if self._closed:
                req.future.set_exception(RuntimeError("engine closed"))
                return req.future
            self._stats["requests"] += 1
            self._pending.setdefault(req.bucket, []).append(req)
            self._cv.notify()
        return req.future

    def separate(self, audio: np.ndarray, timeout: Optional[float] = None
                 ) -> np.ndarray:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(audio).result(timeout)

    def warmup(self, lengths: Sequence[int],
               batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run every (bucket, batch) shape once before traffic, so that
        first requests do not pay cuDNN's and the allocator's first-call
        set-up. Default: EVERY allowed batch size per length (a
        low-concurrency first request dispatches a small batch). Each
        call draws from the engine's generator, as a batch does."""
        for L in lengths:
            blen = self.bucket_of(int(L))
            for bs in (batch_sizes or self.batch_sizes):
                bs = self._round_batch(int(bs))
                mix = np.zeros((bs, 1, blen), np.float32)
                self._run(mix, np.full((bs,), blen, np.int64))

    def stats(self) -> Dict:
        with self._cv:
            s = dict(self._stats)
            lat = sorted(self._latencies)
            s["pending"] = sum(len(v) for v in self._pending.values())
        s["mean_batch_occupancy"] = (
            s["batched_items"] / s["batches"] if s["batches"] else 0.0)
        if lat:
            s["latency_p50_ms"] = 1e3 * lat[len(lat) // 2]
            s["latency_p95_ms"] = 1e3 * lat[min(len(lat) - 1,
                                                int(0.95 * len(lat)))]
        return s

    def close(self, timeout: float = 10.0) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t0 = time.perf_counter()
        self._thread.join(timeout)
        if self._completion_thread is not None:
            self._completion_thread.join(
                max(0.1, timeout - (time.perf_counter() - t0)))
        with self._cv:
            # never-dispatched requests, plus, when a join timed out (a
            # host copy that never returns, or the dispatch thread held at
            # the semaphore by such copies), the batches registered in
            # flight: otherwise their callers would block on
            # future.result() forever after close() returns
            leftovers = list(self._pending.values())
            if self._completion_thread is not None and (
                    self._completion_thread.is_alive()
                    or self._thread.is_alive()):
                leftovers += list(self._inflight.values())
                self._inflight.clear()
            for reqs in leftovers:
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(RuntimeError("engine closed"))
            self._pending.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ internal
    def _round_batch(self, n: int) -> int:
        for bs in self.batch_sizes:
            if bs >= n:
                return bs
        return self.max_batch

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a batch is due; None when closed and drained.

        Serves the bucket holding the oldest pending request; dispatches
        when that bucket has max_batch requests or its oldest request
        has waited max_wait (or the engine is closing)."""
        with self._cv:
            while True:
                if self._pending:
                    # a FULL bucket anywhere dispatches first (oldest-full
                    # wins) so one early straggler in another bucket can't
                    # head-of-line-block a ready batch, UNLESS the oldest
                    # request has already waited out max_wait, which would
                    # otherwise starve a cold bucket forever under
                    # sustained load on a hot shape (latency bound:
                    # max_wait + one sampler call)
                    oldest = lambda b: self._pending[b][0].t_submit  # noqa
                    oldest_bucket = min(self._pending, key=oldest)
                    oldest_age = (time.perf_counter()
                                  - oldest(oldest_bucket))
                    full = [b for b, r in self._pending.items()
                            if len(r) >= self.max_batch]
                    bucket = (min(full, key=oldest)
                              if full and oldest_age < self.max_wait
                              else oldest_bucket)
                    reqs = self._pending[bucket]
                    age = time.perf_counter() - reqs[0].t_submit
                    if (len(reqs) >= self.max_batch or age >= self.max_wait
                            or self._closed):
                        take = reqs[:self.max_batch]
                        rest = reqs[self.max_batch:]
                        if rest:
                            self._pending[bucket] = rest
                        else:
                            del self._pending[bucket]
                        return take
                    self._cv.wait(timeout=self.max_wait - age)
                elif self._closed:
                    return None
                else:
                    self._cv.wait()

    def _dispatch(self, mix: np.ndarray, lengths: np.ndarray):
        """Upload one batch and run ``separate_fn`` on it; returns the
        estimates still on the device (the host copy in :meth:`_finalize`
        is the completion fence). Runs in inference mode: grad mode is
        per thread, and the wire's casts and the lengths are the engine's
        own device work."""
        if self.wire_int16:
            mix = np.clip(mix, -1.0, 1.0)
            mix = np.round(mix * 32768.0).clip(-32768, 32767).astype(
                np.int16)
        with self._device_lock, torch.inference_mode():
            x = torch.from_numpy(mix).to(self.device)
            if self.wire_int16:
                x = x.float() / 32768.0
            lens = torch.from_numpy(lengths.astype(np.int64))
            if self._replicas is not None:
                est = self._split_over_cards(x, lens)
            else:
                kw = {"generator": self._generator}
                if self.pass_lengths:
                    kw["lengths"] = lens.to(self.device)
                est = self.separate_fn(x, **kw)
            if self.wire_int16:
                est = torch.as_tensor(est, device=self.device).float()
                est = torch.round(torch.clamp(est, -1.0, 1.0)
                                  * 32767.0).to(torch.int16)
            elif isinstance(est, torch.Tensor):
                est = est.float()
        return est

    def _split_over_cards(self, x: Tensor, lens: Tensor) -> Tensor:
        """Each replica separates its rows of the batch on its card, in
        its own thread, drawing its rows of the whole batch's draws from
        a copy of the engine's generator; the engine's generator then
        moves on as one call on the whole batch moves it."""
        n = len(self._replicas)
        per = x.shape[0] // n
        start = self._generator.get_state()

        def replica(k: int):
            dev = self.mesh.local[k]
            g = self._replica_generators[k]
            g.set_state(start)
            rows = slice(k * per, (k + 1) * per)
            kw = {"generator": g}
            if self.pass_lengths:
                kw["lengths"] = lens[rows].to(dev)
            with torch.inference_mode(), sharded(self.mesh, index=k,
                                                 count=n):
                est = self._replicas[k](x[rows].to(dev), **kw)
                return torch.as_tensor(est).to(self.device)

        outs = list(self._pool.map(replica, range(n)))
        self._generator.set_state(self._replica_generators[0].get_state())
        return torch.cat(outs)

    def _finalize(self, est) -> np.ndarray:
        est = (est.cpu().numpy() if isinstance(est, torch.Tensor)
               else np.asarray(est))
        if self.wire_int16:
            est = est.astype(np.float32) / 32767.0
        return est

    def _run(self, mix: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        return self._finalize(self._dispatch(mix, lengths))

    def _complete(self, batch: List[_Request], bs: int, est) -> None:
        """Copy one dispatched batch to the host and resolve its futures."""
        try:
            est = self._finalize(est)
            now = time.perf_counter()
            with self._cv:
                self._stats["batches"] += 1
                self._stats["batched_items"] += len(batch)
                self._stats["padded_rows"] += bs - len(batch)
                self._latencies.extend(
                    now - r.t_submit for r in batch)
                del self._latencies[:-1024]
            for i, r in enumerate(batch):
                if not r.future.done():  # close() may have failed it
                    r.future.set_result(
                        np.array(est[i][:, :r.audio.shape[-1]]))
        except Exception as e:  # resolve futures, keep serving
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    def _completion_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._complete(*item)
            finally:
                with self._cv:
                    self._inflight.pop(id(item[0]), None)
                self._inflight_sem.release()

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                if self._queue is not None:
                    self._queue.put(None)  # drain sentinel
                return
            if self._inflight_sem is not None:
                # registered BEFORE the semaphore, so that close() can
                # fail this batch while the dispatch thread waits here
                # behind batches whose host copies never return
                with self._cv:
                    self._inflight[id(batch)] = batch
                self._inflight_sem.acquire()
            try:
                bs = self._round_batch(len(batch))
                blen = batch[0].bucket
                mix = np.zeros((bs, 1, blen), np.float32)
                lens = np.full((bs,), blen, np.int64)
                for i, r in enumerate(batch):
                    L = r.audio.shape[-1]
                    mix[i, 0, :L] = r.audio  # trailing-quiet padding
                    lens[i] = L
                est = self._dispatch(mix, lens)
            except Exception as e:  # dispatch-time failure
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                if self._inflight_sem is not None:
                    with self._cv:
                        self._inflight.pop(id(batch), None)
                    self._inflight_sem.release()
                continue
            if self._queue is None:
                self._complete(batch, bs, est)
            else:
                self._queue.put((batch, bs, est))
