"""Data parallelism on ``torch.distributed`` (port of
ditsep_tpu/parallel/__init__.py).

The JAX package shards the batch axis of one global batch over a device
mesh and lets XLA insert the collectives; the port keeps that model with
explicit collectives. Every process (rank) builds the same global batch,
keeps its rows (``shard_batch``) and holds a full copy of the parameters;
after the backward the trainers average the gradient over the ranks
(``all_reduce_grads_``) before clipping, so every rank applies the
global batch's update. Random draws over a batch axis are made at the
global batch's shape from the generator every rank seeds alike, and each
rank keeps its rows (``sharded``, ``draw_rows``): a step over N ranks
equals the one-process step on the global batch up to float32 reduction
order.

Launch: ``python -m torch.distributed.run --nproc-per-node N -m
ditsep_tpu_torch.cli.<name> --mesh ...`` (NCCL, one card a rank, each
rank on ``cuda:{LOCAL_RANK}``), or with ``--cpu`` (gloo). In one process
without a process group (serving) a mesh is the process's local cards,
and the engine runs a replica on each.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ditsep_tpu_torch.utils.device import resolve_device

# a rank that does not arrive fails the others' rendezvous and collectives
# after this long instead of hanging them
DEFAULT_TIMEOUT_S = 300.0


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device: Union[str, torch.device] = "cuda",
                         backend: Optional[str] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group (``init_process_group``).

    ``None`` arguments are read from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` for the rendezvous);
    ``coordinator_address`` is ``host:port`` of rank 0. A no-op in one
    process started without a launcher, and when the group exists. Under a
    launcher the group is made at any size, 1 included. ``backend``
    defaults to NCCL for a CUDA ``device`` and gloo for the CPU; CUDA
    asked for without a card raises (there is no fallback to the CPU)."""
    if dist.is_initialized():
        return
    if num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return
        num_processes = int(os.environ["WORLD_SIZE"])
    elif num_processes <= 1 and "WORLD_SIZE" not in os.environ:
        return
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel layout, read as JAX's ``Mesh`` is read:
    ``devices`` (an array of ``torch.device`` over every rank, shaped
    ``shape``; ``devices.size`` the data axis' size) and ``axis_names``.
    Beside them: ``group`` (the process group, None in one process),
    ``rank`` and ``world_size`` (processes), and ``local``, the devices
    this process drives (one under a process group; the local cards in
    one process)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    group: Optional[object]
    rank: int
    world_size: int
    local: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        """This process's (first) device."""
        return self.local[0]


def _rank_device(device: torch.device) -> torch.device:
    """The device a rank drives: ``cuda`` means ``cuda:{LOCAL_RANK}``."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def make_mesh(n_data: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None, *,
              device: Union[str, torch.device,
                            Sequence[Union[str, torch.device]]] = "cuda"
              ) -> Mesh:
    """Device mesh; 1-D data-parallel by default (ditsep_tpu/parallel/
    __init__.py:35-64, with its ``shape`` / ``axis_names`` checks).

    Under a process group the mesh is one device a rank, every rank in
    it: ``device`` "cuda" is ``cuda:{LOCAL_RANK}`` (made current), "cpu"
    the CPU, and an indexed card (``"cuda:0"``) lets several gloo ranks
    share it. Without a group it is the process's own devices: "cuda"
    all local cards (the first ``n_data``), "cpu" the CPU, or a list of
    devices (a replica on each). Only the data axis may exceed 1: the
    port shards the batch and nothing else."""
    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
    else:
        dev = resolve_device(device)
        if dist.is_initialized():
            devs = [_rank_device(dev)]
        elif dev.type == "cuda" and dev.index is None:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        else:
            devs = [dev]
    if dist.is_initialized():
        if len(devs) != 1:
            raise ValueError("under a process group each rank drives one "
                             f"device, got {devs}")
        world, rank = dist.get_world_size(), dist.get_rank()
        every = [None] * world
        dist.all_gather_object(every, str(devs[0]))
        all_devs = [torch.device(d) for d in every]
    else:
        world, rank = 1, 0
        all_devs = devs
    if n_data is not None and shape is None:
        all_devs = all_devs[:n_data]
    n = len(all_devs)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    else:
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axis_names "
                             f"{axis_names}")
        total = int(np.prod(shape))
        if total > n:
            raise ValueError(f"mesh shape {shape} needs {total} devices, "
                             f"only {n} available")
        all_devs = all_devs[:total]
    if any(d != 1 for d in shape[1:]):
        raise NotImplementedError(
            f"mesh shape {shape}: the port shards the batch (the first "
            "axis) only")
    if world > 1 and len(all_devs) != world:
        raise ValueError(f"a mesh of {len(all_devs)} devices under a "
                         f"process group of {world}: every rank is in it")
    arr = np.empty(len(all_devs), dtype=object)
    arr[:] = all_devs
    return Mesh(devices=arr.reshape(shape), axis_names=tuple(axis_names),
                group=dist.group.WORLD if dist.is_initialized() else None,
                rank=rank, world_size=world,
                local=tuple(all_devs[rank:rank + 1] if world > 1
                            else all_devs))


def check_one_device_a_rank(mesh: Optional[Mesh], what: str) -> None:
    """Training and evaluation drive one device a process: a mesh of
    several local devices (the serving engine's) raises."""
    if mesh is not None and len(mesh.local) > 1:
        raise ValueError(
            f"{what} runs one device a process: launch one process a card "
            "(python -m torch.distributed.run --nproc-per-node N ... "
            f"--mesh), not one process over {len(mesh.local)} devices")


def data_sharding(mesh: Mesh) -> Callable[[int], slice]:
    """Shard the leading (batch) axis over the data axis: the rows of a
    global batch of ``b`` that this process holds, as a function of
    ``b``. Raises if ``b`` does not split over the data axis."""
    def rows(b: int) -> slice:
        n = mesh.devices.size
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} "
                             "devices (pad it: pad_batch_to_devices)")
        per = b // mesh.world_size
        return slice(mesh.rank * per, (mesh.rank + 1) * per)
    return rows


def replicated(mesh: Mesh) -> Callable[[int], slice]:
    """Every process holds the whole batch."""
    return lambda b: slice(0, b)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def shard_batch(mesh: Mesh, batch):
    """This process's rows of a global batch (a tuple, list or dict of
    numpy arrays or tensors with the batch axis first) as tensors on its
    device. Raises if the batch does not split over the data axis, as
    JAX's sharding does."""
    rows = data_sharding(mesh)

    def take(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x[rows(x.shape[0])].to(mesh.device)

    return _tree_map(take, batch)


def process_index() -> int:
    """This process's rank in the process group, 0 without one (JAX's
    ``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The process group's size, 1 without one (JAX's
    ``jax.process_count``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_rank_zero() -> bool:
    """(reference: src/utils/ddp.py:4-10)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def pad_batch_to_devices(batch, n_devices: int):
    """Pad the leading axis up to a multiple of the device count by
    repeating the last row (every rank takes a full shard); returns
    (batch, n_real)."""
    def pad(x):
        b = x.shape[0]
        rem = b % n_devices
        if rem == 0:
            return x
        reps = n_devices - rem
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand((reps,) + tuple(x.shape[1:]))])
        return np.concatenate([x, np.repeat(x[-1:], reps, axis=0)], axis=0)

    leaves = _leaves(batch)
    n_real = leaves[0].shape[0] if leaves else 0
    return _tree_map(pad, batch), n_real


# -- collectives ------------------------------------------------------------
def _grouped(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None


@torch.no_grad()
def all_reduce_grads_(grads: Sequence[torch.Tensor],
                      mesh: Optional[Mesh]) -> None:
    """Average ``grads`` over the ranks in place: each dtype's gradients
    packed into one flat buffer, summed, divided by the world size. Call
    it after the backward and before the clip, so the clip sees the
    global gradient. A no-op without a process group."""
    if not _grouped(mesh):
        return
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world_size)
        torch._foreach_copy_(group, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in group]), group)])


@torch.no_grad()
def all_reduce_mean_(tensor: torch.Tensor, mesh: Optional[Mesh]
                     ) -> torch.Tensor:
    """The mean of ``tensor`` over the ranks, in place (logged scalars,
    per-rank means of equal shards); returns it."""
    if _grouped(mesh):
        dist.all_reduce(tensor, group=mesh.group)
        tensor.div_(mesh.world_size)
    return tensor


def all_reduce_metrics(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """Each scalar tensor of ``metrics`` averaged over the ranks (a mean
    over equal shards is the global batch's), in one collective."""
    if not _grouped(mesh) or not metrics:
        return metrics
    flat = all_reduce_mean_(torch.stack(
        [v.float().reshape(()) for v in metrics.values()]), mesh)
    return dict(zip(metrics, flat.unbind()))


def all_gather_rows(x: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    """Every rank's rows concatenated in rank order, on the host (through
    ``all_gather_object``: gloo gathers no CUDA tensor)."""
    if not _grouped(mesh):
        return x
    parts = [None] * mesh.world_size
    dist.all_gather_object(parts, x, group=mesh.group)
    return np.concatenate(parts, axis=0)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` on every rank."""
    if not _grouped(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


# -- this process's rows of the global batch's draws -------------------------
@dataclasses.dataclass(frozen=True)
class Shard:
    """Rows ``index`` of ``count`` equal shards of a global batch; ``mesh``
    reduces over the ranks where the computation couples the batch."""

    index: int
    count: int
    mesh: Optional[Mesh] = None


_SHARD: contextvars.ContextVar = contextvars.ContextVar("ditsep_shard",
                                                        default=None)


@contextlib.contextmanager
def sharded(mesh: Optional[Mesh], index: Optional[int] = None,
            count: Optional[int] = None):
    """Run the block as one shard of the global batch: this rank's
    (``index`` / ``count`` default to the rank and the world size; the
    serving engine names a replica's). Inside it ``draw_rows`` draws at
    the global shape and keeps the shard's rows, and the losses that
    couple the batch (``auraloss.pit_min``) reduce over ``mesh``.
    ``mesh`` None runs the block as it is."""
    if mesh is None:
        yield
        return
    shard = Shard(mesh.rank if index is None else index,
                  mesh.world_size if count is None else count, mesh)
    token = _SHARD.set(shard)
    try:
        yield shard
    finally:
        _SHARD.reset(token)


@contextlib.contextmanager
def unsharded():
    """Run the block on the global batch itself (a draw whose rows are
    not items, e.g. the varprop time sampler's proposals)."""
    token = _SHARD.set(None)
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard() -> Optional[Shard]:
    return _SHARD.get()


def global_rows(b: int) -> int:
    """The global batch of which a shard holds ``b`` rows."""
    s = _SHARD.get()
    return b if s is None else b * s.count


def take_rows(x, shard: Optional[Shard] = None):
    """The current (or ``shard``'s) rows of a global-batch array."""
    s = _SHARD.get() if shard is None else shard
    if s is None or s.count == 1:
        return x
    per = x.shape[0] // s.count
    return x[s.index * per:(s.index + 1) * per]


def draw_rows(fn: Callable[[Tuple[int, ...]], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """``fn(shape)``, a random draw whose axis 0 is the batch, in a shard:
    drawn at the global batch's shape (so the generator's stream is the
    one-process run's) and the shard's rows kept."""
    shape = tuple(shape)
    s = _SHARD.get()
    if s is None or s.count == 1:
        return fn(shape)
    return take_rows(fn((shape[0] * s.count,) + shape[1:]), s)


def couples_batch(what: str) -> Optional[Shard]:
    """The current shard when a computation that couples the batch runs
    over more than one (it must reduce over the ranks, or refuse); None
    when it sees the whole batch. ``what`` names it in the error when the
    shards have no process group to reduce over."""
    s = _SHARD.get()
    if s is None or s.count == 1:
        return None
    if not _grouped(s.mesh):
        raise NotImplementedError(
            f"{what} couples the batch: its shards need a process group")
    return s


# -- local launcher -----------------------------------------------------------
def free_port() -> int:
    """A TCP port free on 127.0.0.1 at the time of the call."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, nproc: int, port: int, device: str,
               backend: Optional[str], timeout_s: float, args) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    initialize_multihost(f"127.0.0.1:{port}", nproc, rank, device=device,
                         backend=backend, timeout_s=timeout_s)
    try:
        fn(make_mesh(device=device), *args)
    finally:
        shutdown()


def launch(fn: Callable, nproc: int, *args, device: str = "cuda",
           backend: Optional[str] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(mesh, *args)`` in ``nproc`` new processes, ranks of one
    process group on a free port of 127.0.0.1 (``fn`` and ``args`` must
    pickle: a module-level function; a tensor among ``args`` is shared
    with every rank, not copied, as torch.multiprocessing hands tensors
    over). Each rank drives ``device`` ("cuda":
    ``cuda:{rank}``; "cuda:0": every rank on that card, over gloo). Raises
    when a rank fails, and kills every rank still running after
    ``timeout_s`` (the rendezvous and collectives time out after it too),
    so a lost rank fails the run instead of hanging it."""
    import multiprocessing
    import multiprocessing.connection
    import time

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nproc, port, device, backend,
                               timeout_s, args))
             for r in range(nproc)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        # the first rank to fail ends the run: the others would wait in a
        # collective until the timeout
        running = list(procs)
        while running and time.monotonic() < deadline:
            multiprocessing.connection.wait(
                [p.sentinel for p in running],
                timeout=deadline - time.monotonic())
            running = [p for p in running if p.exitcode is None]
            if any(p.exitcode for p in procs):
                break
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(5)
    failed = {r: p.exitcode for r, p in enumerate(procs)
              if p.exitcode and p not in alive}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}; "
                           f"{len(alive)} others killed")
    if alive:
        raise TimeoutError(f"{len(alive)} of {nproc} ranks still running "
                           f"after {timeout_s} s: killed")
