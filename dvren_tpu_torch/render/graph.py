"""CUDA Graph capture and replay: the port's ``enable_graph``.

The JAX package answers ``enable_graph`` with an ahead-of-time compile:
the render becomes one executable that every later frame replays. On the
card the counterpart is a CUDA Graph. :func:`capture` runs a function
once on a side stream (the warm-up loads the kernel library, launches
each kernel once and lets the caching allocator settle), then records one
more run into a ``torch.cuda.CUDAGraph``; :meth:`CapturedGraph.replay`
runs the recorded kernels again, with no Python and no launch overhead
per kernel.

A graph reads and writes fixed addresses. Its inputs are the tensors the
function read while it was recorded (the field's parameters, a schedule,
a static camera or cotangent buffer that the caller refills before each
replay; the graph keeps the function, and with it every tensor it closes
over), and its outputs are the tensors it returned, which every replay
overwrites: callers copy them out (:func:`clone_outputs`). A caller keys
each capture on what the graph reads (:func:`tensor_key`: the address,
shape, dtype and device of each input tensor), so that a new field object
re-captures and an in-place optimizer step, which keeps the addresses,
replays.

Nothing inside a captured function may wait for the device or read a
value to the host (``.item()``, ``.cpu()``, ``torch.nonzero``,
``torch.unique``, a shape taken from data) or upload a host array; a
capture that meets one raises, and :func:`capture` raises with the
capture's error. The Python launch counters of the kernel wrappers
(``fused_tiles.tile_forward.launches`` and the rest) move when a kernel
is recorded, not when a graph replays it: :attr:`CapturedGraph.launches`
holds the counts recorded into the graph.

A captured graph sits in a reference cycle (its function closes over its
owner, which holds the graph), so only Python's cycle collector frees it,
and destroying a graph while another records invalidates that capture.
:func:`capture` therefore collects first and holds the collector off
while it records.

A training step is JAX's ``jax.jit`` of the step (and, replayed k times,
its ``lax.scan`` block): :func:`capture_step` records a step that
renders through autograd, calls ``backward`` and steps an optimizer. Its
warm-up takes a real optimizer step, which creates the optimizer's state
tensors (Adam's ``step``, ``exp_avg``, ``exp_avg_sq``) at the addresses
the recording reads; the parameters and that state are then restored in
place (:func:`snapshot_step`, :func:`restore_step`), so the first replay
is the caller's step 1. The gradients are set to None before the
recording, so that the backward allocates them from the graph's pool and
every replay rewrites them (PyTorch's whole-network capture). An
optimizer must keep its step count on the device to be recorded
(``torch.optim.Adam(..., capturable=True)``); :func:`capture_step`
refuses one that does not.

A sharded training step (``parallel/shard.py``) records its collectives
with it: over NCCL the all-reduce is work on the device's streams, which
the graph replays (the default capture mode records it: NCCL's watchdog
thread broke no capture on the card); gloo sums on the host, so a gloo
mesh's steps run eagerly (:func:`available` with the group's backend).
"""

from __future__ import annotations

import dataclasses
import gc

import torch

from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.utils import trace
from dvren_tpu_torch.utils.pytree import tree_map


def launch_counts() -> dict:
    """The launch counter of every kernel wrapper, by kernel name
    (``utils/trace.py::KERNELS``)."""
    return {k.name: k.wrapper.launches for k in trace.KERNELS}


def reset_launch_counts() -> None:
    """Set the launch counter of every kernel wrapper to 0."""
    for k in trace.KERNELS:
        k.wrapper.launches = 0


def tensor_key(*tensors) -> tuple:
    """What a graph that reads ``tensors`` depends on: the address, shape,
    dtype and device of each."""
    return tuple((int(t.data_ptr()), tuple(t.shape), str(t.dtype),
                  str(t.device)) for t in tensors)


def clone_outputs(tree):
    """A copy of every tensor in ``tree`` (dataclasses, tuples, lists and
    dicts of tensors), out of the graph's buffers."""
    return tree_map(lambda t: t.clone(), tree)


@dataclasses.dataclass
class CapturedGraph:
    """A recorded CUDA Graph, the outputs its replays overwrite, the
    kernel launches recorded into it (by kernel name, those above 0) and
    the milliseconds the warm-up and the capture took (the
    ``graph.capture`` span). ``fn`` is the recorded function, kept so
    that every tensor it closes over (a camera leaf, a parameter view)
    lives as long as the graph that reads its address: freed, its memory
    would be handed out again and a replay would read whatever landed
    there. ``clock``: the stage clock recorded into the graph with
    tracing on (``utils/trace.py``; None with it off), read after each
    replay; ``replays`` counts them."""

    graph: torch.cuda.CUDAGraph
    outputs: object
    launches: dict
    capture_ms: float
    fn: object = None
    clock: object = None
    replays: int = 0

    def owned_by(self, owner: str) -> "CapturedGraph":
        """Keep the stage readings of this graph's replays under
        ``owner`` (``fit.step``, ``posed.render``, ...); returns self."""
        if self.clock is not None:
            self.clock.owner = owner
        return self

    def replay(self):
        """Run the recorded kernels again; returns the outputs (the
        graph's own buffers: copy them before the next replay). With a
        stage clock recorded, the previous replay's stage times are read
        first if that replay has completed."""
        with trace.span("graph.replay", unit=self.replays):
            if self.clock is not None:
                self.clock.poll()
            self.graph.replay()
            if self.clock is not None:
                self.clock.arm()
        self.replays += 1
        return self.outputs


def available(device, backend: str | None = None) -> bool:
    """Whether a CUDA graph can record work on ``device`` and, given a
    process group's ``backend``, the group's collectives: NCCL enqueues
    its all-reduce on the device's streams, which a graph records; gloo
    runs it on the host, which no graph can record."""
    return torch.device(device).type == "cuda" and backend in (None, "nccl")


def capture(fn, device, before_record=None) -> CapturedGraph:
    """Record ``fn()`` (no arguments; it reads its inputs from tensors
    whose addresses stay fixed) as a CUDA Graph on ``device``, after one
    eager run on a side stream; ``before_record()`` runs between the two.
    With tracing on, the recording holds a stage clock: the stage marks
    the recorded run makes (``utils/trace.py::stage``; the warm-up's go
    nowhere) and its end mark after ``fn`` returns, as event nodes.
    Raises ``RuntimeError`` with the capture's error when ``fn`` cannot be
    recorded."""
    device = torch.device(device)
    if not available(device):
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    with trace.timed("graph.capture") as timer:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        if before_record is not None:
            before_record()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph):
                scope = trace.clock("graph", device, graph=True)
                with scope:
                    outputs = fn()
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture failed ({type(exc).__name__}: {exc}); "
                f"the captured path waited for the device, read a value "
                f"to the host or uploaded a host array") from exc
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        after = launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    return CapturedGraph(graph=graph, outputs=outputs, launches=launches,
                         capture_ms=timer.ms, fn=fn,
                         clock=scope.clock)


def snapshot_step(params, optimizer) -> tuple:
    """Copies of ``params`` and of every tensor in ``optimizer``'s state
    for them, as they are before a step that :func:`restore_step` undoes.
    The state of a parameter the optimizer has not stepped yet is empty:
    its tensors appear with the step and are zeroed by the restore."""
    with torch.no_grad():
        values = [p.detach().clone() for p in params]
        state = [{k: v.clone() for k, v in optimizer.state[p].items()
                  if isinstance(v, torch.Tensor)}
                 if p in optimizer.state else {} for p in params]
    return values, state


def restore_step(snapshot: tuple, params, optimizer) -> None:
    """Put ``params`` and ``optimizer``'s state back as
    :func:`snapshot_step` saw them, in place (``copy_``; state tensors
    made since, zeroed: a fresh Adam's ``step``, ``exp_avg`` and
    ``exp_avg_sq`` are zeros), so that every address stays the one a
    recording reads."""
    values, state = snapshot
    with torch.no_grad():
        for p, v, saved in zip(params, values, state):
            p.copy_(v)
            for k, t in optimizer.state.get(p, {}).items():
                if not isinstance(t, torch.Tensor):
                    continue
                if k in saved:
                    t.copy_(saved[k])
                else:
                    t.zero_()


def check_capturable(optimizer) -> None:
    """Raise ``DvrenError`` for an optimizer that keeps its step count on
    the host (``capturable=False``): a recorded step would replay the
    step count it was recorded with."""
    for group in optimizer.param_groups:
        check(group.get("capturable", True),
              f"{type(optimizer).__name__} with capturable=False cannot be "
              f"recorded into a CUDA graph: build it with capturable=True "
              f"(its step count then lives on the device)")


def capture_step(fn, device, params, optimizer) -> CapturedGraph:
    """Record the training step ``fn()`` (it renders through autograd,
    calls ``backward``, steps ``optimizer`` over ``params`` and returns
    the loss) with :func:`capture`, then undo its warm-up's optimizer step
    (:func:`restore_step`), so the first replay is the step the caller
    asked for. The gradients are set to None before the recording, so
    they come from the graph's pool. Raises ``DvrenError`` for an
    optimizer that cannot be recorded (:func:`check_capturable`)."""
    check_capturable(optimizer)
    params = list(params)
    snapshot = snapshot_step(params, optimizer)
    graph = capture(fn, device, before_record=lambda: optimizer.zero_grad(
        set_to_none=True))
    restore_step(snapshot, params, optimizer)
    return graph
