"""Ranks, process groups and the one collective of the sharded paths.

Counterpart of ``dvren_tpu/parallel/mesh.py``. JAX's 1-D mesh names the
devices one SPMD program runs over; here a rank is one process driving one
device, and a :class:`Mesh` holds the process group that joins the ranks,
this process's rank, their number and its device. JAX's ``shard_map`` body
becomes the code each rank runs, and every cross-rank step of
:mod:`dvren_tpu_torch.parallel.shard` is a sum over the group: one
``dist.all_reduce`` in :func:`all_reduce_sum` (inside autograd,
:class:`AllReduceSum`). At setup, :func:`replicated` broadcasts rank 0's
tensors so the ranks start bit-equal.

Ranks come from :func:`launch` (spawned processes joined by a file store:
the tests, ``chip_smoke.py`` and :func:`dvren_tpu_torch.parallel.dryrun.
dryrun_multichip`) or from any launcher that initialises the default
process group (``torchrun``), after which :func:`make_mesh` builds the
mesh.

Backends: NCCL for CUDA devices and gloo for the CPU unless the caller
names one. NCCL refuses two ranks on one GPU; gloo all-reduces CUDA
tensors (through host memory), so ranks that share a card name
``backend="gloo"``. Nothing falls back from one backend or device to
another on its own.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from dvren_tpu_torch.core.context import resolve_device

_JOIN_S = 60.0     # how long a finished rank may take to exit


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process group over the mesh's
    ranks, this process's rank in it, the rank count, this rank's device
    and the group's backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def rank_device(rank: int, device=None) -> torch.device:
    """The device of ``rank``: ``device`` when named, else
    ``cuda:{rank % device_count}``; a :class:`DvrenError` when CUDA is
    asked for and absent (as :func:`resolve_device` raises)."""
    if device:
        return resolve_device(device)
    return resolve_device(f"cuda:{rank % max(torch.cuda.device_count(), 1)}")


def default_backend(device: torch.device) -> str:
    """NCCL on a CUDA device, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(n_devices: int | None = None, device=None,
              backend: str | None = None) -> Mesh | None:
    """The mesh over the first ``n_devices`` ranks (default: all) of the
    initialised default process group.

    ``device``: this rank's device (default :func:`rank_device`). The
    group is the default one when it spans the mesh with ``backend``
    (default :func:`default_backend` of the device), else a new group over
    the mesh's ranks with that backend, which every rank of the default
    group must create together: ranks past the mesh get None. A
    ``ValueError`` when ``n_devices`` exceeds the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (launch(), or torchrun and "
                           "init_process_group)")
    world = dist.get_world_size()
    rank = dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} ranks present")
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    dev = rank_device(rank, device)
    backend = backend or default_backend(dev)
    if n == world and backend == dist.get_backend():
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)), backend=backend)
    if rank >= n:
        return None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=group, rank=rank, size=n, device=dev, backend=backend)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the mesh's ranks, in place (``x`` must be
    contiguous): the one cross-rank step of the sharded paths. Every rank
    gets the same bits."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


class AllReduceSum(torch.autograd.Function):
    """:func:`all_reduce_sum` inside autograd, on a copy of ``x``. The
    backward passes the gradient through unchanged: every rank computes
    the same replicated loss from the summed value, so each rank's
    gradient of its own part is its share, and the ranks' parameter
    gradients are summed once after ``backward()``. (The backward of
    ``torch.distributed.nn.functional.all_reduce`` all-reduces again,
    which would count every gradient D times.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(mesh, x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` overwritten, in place, with rank 0's ``x`` (a broadcast): the
    ranks start from equal bits."""
    dist.broadcast(x, src=0, group=mesh.group)
    return x


def batch_sharded(mesh: Mesh, x):
    """This rank's contiguous slice of dim 0 of ``x``; a ``ValueError``
    when the mesh's size does not divide it."""
    n = int(x.shape[0])
    if n % mesh.size:
        raise ValueError(f"dim 0 of size {n} not divisible by mesh size "
                         f"{mesh.size}")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _rank_main(rank, n, init_method, backend, device, fn, args, results):
    """One spawned rank: join the group, build the mesh, run
    ``fn(mesh, *args)``, and report to the parent (rank 0 its pickled
    result, every rank its success or its traceback)."""
    try:
        dev = rank_device(rank, device)
        backend = backend or default_backend(dev)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=n, rank=rank)
        try:
            out = fn(make_mesh(n, device=dev, backend=backend), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, n_devices: int, *args, backend: str | None = None,
           device=None):
    """Run ``fn(mesh, *args)`` on ``n_devices`` spawned ranks and return
    rank 0's result.

    Each rank is a process of the ``spawn`` start method, so ``fn`` and
    ``args`` are pickled: ``fn`` must be importable by its module path,
    from a module that the ranks can import, and the result should hold
    CPU tensors or numpy. The ranks join one process group through a file
    store in a temporary directory; ``backend`` and ``device`` are as
    :func:`make_mesh` takes them, for every rank (``device="cpu"`` for CPU
    ranks, ``"cuda:0"`` for ranks sharing one card). When a rank fails,
    the others are stopped and a ``RuntimeError`` carries the failing
    rank's traceback."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"launch needs at least one rank, got {n}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="dvren_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, init_method, backend, device, fn,
                                   args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            out = _collect(procs, results)
        finally:
            for p in procs:
                p.join(_JOIN_S)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return pickle.loads(out)


def _collect(procs, results):
    """Rank 0's pickled result once every rank has reported success; a
    ``RuntimeError`` (after stopping the ranks still running) at the first
    failure, or when a rank exits without reporting."""
    n = len(procs)
    done = {}
    try:
        while len(done) < n:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                gone = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if not gone:
                    continue
                try:    # its report may still be on the way
                    rank, ok, payload = results.get(timeout=5.0)
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"rank {gone[0]} of {n} exited with code "
                        f"{procs[gone[0]].exitcode} without reporting"
                    ) from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            done[rank] = payload
    except BaseException:
        for p in procs:
            if p.is_alive():
                p.terminate()
        raise
    return done[0]
