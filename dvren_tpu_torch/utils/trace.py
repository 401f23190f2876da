"""The port's tracing: host spans, device stage clocks, counters, and the
kernel table.

Off by default; ``enable(True)`` switches it on for the process, and
``enable(False)`` off again. Off, :func:`span` and :func:`clock` return
one shared no-op context, :func:`count` returns at once, :func:`stage`
returns at once where no clock is open, and nothing is recorded: no
``record_function`` is entered and no CUDA event is made, so a graph
recorded with tracing off is the graph the program records without this
module.

**Spans** (host). ``with span("graph.replay"):`` enters
``torch.profiler.record_function("dvren.graph.replay")`` while a profiler
session runs (outside one the range would cost host time and record
nothing), so the span lands in any profiler session on the device
trace's clock. Each span is kept in memory: its name, its parent (the
span open on this thread, or the one handed to :func:`under` in a pool
thread), its start and end (``time.perf_counter_ns``) and its unit (the
step or frame number its outermost numbered span was given). Spans are aggregated by name (count,
total, self time: the duration less the part of it that its children
cover, and max); raw records are kept up to :data:`MAX_RECORDS`.
:func:`timed` is a span that reads the host clock with tracing off as
well, for the program's once-per-set-up timers (``capture_ms``,
``schedule_build_s``); it is recorded only with tracing on. This module
never starts a profiler session.

**Stage clocks** (device). ``stage("gather")`` marks the start of a named
stage of the innermost open clock (:func:`clock`); a stage lasts until
the clock's next mark, the last one until the clock's end mark, so one
run's stages partition its device work, and a name marked twice sums. On
a CUDA device a mark records a timing event on the current stream: inside
a CUDA graph's recording (``render/graph.py::capture`` opens the clock)
an event-record node of the graph, which every replay records again;
``CapturedGraph.replay`` reads the previous replay's stage times once its
end event has completed (``query()``), never waiting for it. Eagerly on
the CPU the marks read the host clock and the reading is taken when the
clock closes. :func:`timed_clock` is a clock that reads with tracing off
as well, for the Renderer's per-stage stats; its reading is recorded
only with tracing on. The open clocks form one stack for the process:
autograd runs a CUDA backward on a thread of its own. Readings are kept
per owner (``fit.step``, ``posed.render``, ...) and per stage. Where
autograd runs an adjoint with no Python of the program's before it,
:func:`stage_on_backward` marks its start: an identity node, recorded
with tracing on only, whose backward marks the stage as the gradients
arrive.

**Counters**: ``count(name, n)``.

:func:`snapshot` returns all of it as one JSON-able dict and
:func:`reset` empties it.

:data:`KERNELS` is the program's kernel table: each kernel wrapper that
counts its launches (``.launches``), by the name ``render/graph.py``'s
``launch_counts`` uses, and the CUDA ``__global__`` it launches
(``dvren_tpu_torch/csrc``), which is the name a profiler's trace shows.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import itertools
import statistics
import threading
import time
import weakref
from typing import NamedTuple

import torch

PREFIX = "dvren."
MAX_RECORDS = 1 << 16       # raw span records kept; aggregates go on
MAX_READINGS = 1 << 16      # stage readings kept per owner and stage


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel wrapper: its name, where it lives, and the CUDA symbol
    it launches."""

    name: str
    module: str
    attr: str
    symbol: str

    @property
    def wrapper(self):
        """The wrapper function (its ``.launches`` counts launches)."""
        return getattr(importlib.import_module(self.module), self.attr)


_OPS = "dvren_tpu_torch.ops."
KERNELS = (
    Kernel("fused_tiles", _OPS + "fused_tiles", "tile_forward",
           "tile_forward_kernel"),
    Kernel("fused_tiles_bwd", _OPS + "fused_tiles", "tile_backward",
           "tile_backward_kernel"),
    Kernel("packed_table", _OPS + "packed_transpose", "build_rows",
           "packed_table_kernel"),
    Kernel("packed_table_bwd", _OPS + "packed_transpose",
           "table_grad_to_params", "packed_table_grad_kernel"),
    Kernel("packed_table16", _OPS + "packed_transpose", "build_rows16",
           "packed_table16_kernel"),
    # K5b is K4's kernel templated on a 16-bit row
    Kernel("packed_table16_bwd", _OPS + "packed_transpose",
           "table16_grad_to_params", "packed_table_grad_kernel"),
    Kernel("banks_to_rows", _OPS + "packed_transpose", "banks_to_rows",
           "banks_to_rows_kernel"),
    Kernel("hash_tiles", _OPS + "hash_tiles", "hash_tile_forward",
           "hash_forward_kernel"),
    Kernel("hash_tiles_bwd", _OPS + "hash_tiles", "hash_tile_backward",
           "hash_backward_kernel"),
    Kernel("hash_grid", _OPS + "hash_grid", "hash_grid_forward_tiles",
           "hash_grid_forward_kernel"),
    Kernel("hash_grid_bwd", _OPS + "hash_grid", "hash_grid_backward_tiles",
           "hash_grid_backward_kernel"),
    Kernel("integrate", _OPS + "integrate_fused", "integrate_forward",
           "integrate_forward_kernel"),
    Kernel("integrate_bwd", _OPS + "integrate_fused", "radiance_vjp",
           "integrate_backward_kernel"),
    Kernel("stratified_jitter", _OPS + "rng", "stratified_jitter",
           "stratified_jitter_kernel"),
    Kernel("posed_build", _OPS + "posed_build", "posed_build",
           "posed_build_kernel"),
    Kernel("packed_eval", _OPS + "packed_eval", "packed_eval_forward",
           "packed_eval_forward_kernel"),
    # the backward's keys, cub's sort and the bounds launch beside it
    Kernel("packed_eval_bwd", _OPS + "packed_eval", "packed_eval_backward",
           "packed_eval_segment_kernel"),
)


class SpanRecord(NamedTuple):
    """One closed span: ids are unique in the process; ``parent`` is the
    enclosing span's id or None; times in ``perf_counter_ns``."""

    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int
    unit: int | None


class _NoOp:
    """The shared context tracing off hands out: it does nothing."""

    seconds = ms = 0.0
    clock = None

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()


class _Span:
    """An open span; with ``record`` false (a :func:`timed` span with
    tracing off) it only reads the host clock."""

    __slots__ = ("name", "unit", "record", "id", "parent", "t0", "t1",
                 "kids", "_rf")

    def __init__(self, name: str, unit, record: bool):
        self.name, self.unit, self.record = name, unit, record
        self.parent = None
        self.kids = []
        self.t0 = self.t1 = 0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def __enter__(self):
        self._rf = None
        if self.record:
            _TRACER.open(self)
            if torch.autograd._profiler_enabled():
                self._rf = torch.profiler.record_function(PREFIX + self.name)
                self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.record:
            if self._rf is not None:
                self._rf.__exit__(*exc)
            _TRACER.close(self)
        return False


class _Adopt:
    """Makes ``parent`` the enclosing span of this thread's next spans."""

    def __init__(self, parent: _Span):
        self.parent = parent

    def __enter__(self):
        _TRACER.stack().append(self.parent)

    def __exit__(self, *exc):
        _TRACER.stack().pop()
        return False


class _Clock:
    """A stage clock: named marks, an end mark, and the reading they
    give. ``graph``: recorded inside a CUDA graph, read after each
    replay (:meth:`arm`, :meth:`poll`); else read once, when it closes
    (host) or when its end event has completed (CUDA, eager)."""

    def __init__(self, owner: str, cuda: bool, graph: bool):
        self.owner, self.cuda, self.graph = owner, cuda, graph
        self.marks = []
        self.end = None
        self.armed = False

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter_ns()
        ev = torch.cuda.Event(enable_timing=True, external=self.graph)
        ev.record()
        return ev

    def mark(self, name: str) -> None:
        self.marks.append((name, self._stamp()))

    def close(self) -> None:
        self.end = self._stamp()

    def arm(self) -> None:
        """A replay was launched: its stage times are to be read."""
        self.armed = True

    def poll(self) -> None:
        """Keep the armed run's reading if it has completed; never
        waits."""
        if not self.armed or (self.cuda and not self.end.query()):
            return
        self.armed = False
        if _TRACER.on:
            _TRACER.reading(self.owner, self.reading())

    def reading(self) -> dict:
        """ms by stage, a name marked more than once summed."""
        stamps = [ev for _, ev in self.marks] + [self.end]
        out = {}
        for (name, a), b in zip(self.marks, stamps[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e-6
            out[name] = out.get(name, 0.0) + ms
        return out


class _ClockScope:
    """``with clock(...) as c``: ``c`` is the open clock (None with
    tracing off). After the block, :attr:`clock` is None where the block
    marked no stage (no end mark is recorded then) or failed. ``timed``
    (:func:`timed_clock`): the block's end waits for the end mark and the
    reading is recorded with tracing on only."""

    def __init__(self, owner: str, device, graph: bool, timed: bool = False):
        dev = torch.device(device) if device is not None else None
        self.clock = _Clock(owner, dev is not None and dev.type == "cuda",
                            graph)
        self.timed = timed

    def __enter__(self):
        _TRACER.clocks().append(self.clock)
        return self.clock

    def __exit__(self, *exc):
        _TRACER.clocks().pop()
        clk = self.clock
        if exc[0] is not None or not clk.marks:   # nothing to read
            self.clock = None
            return False
        clk.close()
        if self.timed:
            if clk.cuda:
                clk.end.synchronize()
            if _TRACER.on:
                _TRACER.reading(clk.owner, clk.reading())
        elif clk.graph:
            _TRACER.watch(clk)         # armed by each replay
        else:
            clk.arm()
            if clk.cuda:
                _TRACER.watch(clk)
            else:
                clk.poll()
        return False


class _Tracer:
    """The process's trace state (one instance, :data:`_TRACER`)."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._open_clocks = []
        self._graphs = weakref.WeakSet()   # clocks of recorded graphs
        self._pending = []                 # eager CUDA clocks not read yet
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.spans = {}          # name -> [count, total, self, max] ns
            self.records = []
            self.dropped = 0
            self.stages = {}         # owner -> {"runs", "stages": {: [ms]}}
            self.counters = {}

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        s = getattr(self._local, "spans", None)
        if s is None:
            s = self._local.spans = []
        return s

    def clocks(self) -> list:
        """The open clocks, innermost last. One stack for the process,
        not a thread's: autograd runs a CUDA backward on a worker thread
        of its own, whose stage marks go to the clock the step opened."""
        return self._open_clocks

    # -- spans
    def open(self, sp: _Span) -> None:
        st = self.stack()
        parent = st[-1] if st else None
        sp.id = next(self._ids)
        sp.parent = parent
        if parent is not None and parent.unit is not None:
            sp.unit = parent.unit
        st.append(sp)

    def close(self, sp: _Span) -> None:
        self.stack().pop()
        dur = sp.t1 - sp.t0
        covered = 0
        edge = sp.t0
        with self._lock:
            for a, b in sorted(sp.kids) if sp.kids else ():
                a, b = max(a, edge), min(b, sp.t1)
                if b > a:
                    covered += b - a
                    edge = b
            if sp.parent is not None:
                sp.parent.kids.append((sp.t0, sp.t1))
            agg = self.spans.setdefault(sp.name, [0, 0, 0, 0])
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - covered
            agg[3] = max(agg[3], dur)
            if len(self.records) < MAX_RECORDS:
                self.records.append(SpanRecord(
                    sp.id, sp.name,
                    None if sp.parent is None else sp.parent.id,
                    sp.t0, sp.t1, sp.unit))
            else:
                self.dropped += 1

    # -- stage clocks
    def watch(self, clk: _Clock) -> None:
        """Poll ``clk`` in :func:`snapshot`: a graph's clock while the
        graph lives, an eager one until it is read."""
        with self._lock:
            if clk.graph:
                self._graphs.add(clk)
            else:
                self._pending.append(clk)

    def reading(self, owner: str, by_stage: dict) -> None:
        with self._lock:
            st = self.stages.setdefault(owner, {"runs": 0, "stages": {}})
            st["runs"] += 1
            for name, ms in by_stage.items():
                vals = st["stages"].setdefault(name, [])
                if len(vals) < MAX_READINGS:
                    vals.append(ms)

    def poll_all(self) -> None:
        with self._lock:
            clocks = list(self._graphs) + self._pending
        for clk in clocks:
            clk.poll()
        with self._lock:
            self._pending = [c for c in self._pending if c.armed]


_TRACER = _Tracer()


def enable(on: bool = True) -> None:
    """Switch tracing on or off for the process."""
    _TRACER.on = bool(on)


def span(name: str, unit: int | None = None):
    """A host span named ``dvren.<name>`` in the profiler; ``unit``: the
    step or frame number (kept unless an enclosing span has one). Off,
    the shared no-op context."""
    if not _TRACER.on:
        return _NOOP
    return _Span(name, unit, True)


def timed(name: str):
    """A span whose host time is read with tracing off too (``.seconds``,
    ``.ms`` after it closes); recorded as :func:`span` is only with
    tracing on."""
    return _Span(name, None, _TRACER.on)


def spanned(name: str, counter: str | None = None):
    """Decorator: each call of the function runs in :func:`span` ``name``
    and adds 1 to ``counter`` (tracing on only)."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _TRACER.on:
                return fn(*args, **kwargs)
            if counter is not None:
                count(counter)
            with _Span(name, None, True):
                return fn(*args, **kwargs)
        return traced
    return wrap


def current():
    """The span open on this thread (None with tracing off or none
    open): hand it to :func:`under` in a pool thread."""
    if not _TRACER.on:
        return None
    st = _TRACER.stack()
    return st[-1] if st else None


def under(parent):
    """Spans opened on this thread inside the context get ``parent``
    (from :func:`current`) as their enclosing span."""
    if parent is None or not _TRACER.on:
        return _NOOP
    return _Adopt(parent)


def clock(owner: str, device=None, graph: bool = False):
    """Open a stage clock for the block: :func:`stage` marks go to it and
    its end mark is recorded when the block ends. ``device``: a CUDA
    device times the stages with events, anything else (or None) with the
    host clock. ``graph``: the block is a CUDA graph's recording, read
    after each replay (:meth:`_Clock.arm`, :meth:`_Clock.poll`). Off,
    the no-op context (``as`` gives None)."""
    if not _TRACER.on:
        return _NOOP
    return _ClockScope(owner, device, graph)


def timed_clock(owner: str, device=None):
    """A stage clock open with tracing off too (``as`` gives the clock:
    its ``reading()`` after the block, ms by stage, the device waited
    for); its reading is recorded as :func:`clock`'s are only with
    tracing on. Not for a CUDA graph's recording."""
    return _ClockScope(owner, device, False, timed=True)


def stage(name: str) -> None:
    """Mark the start of stage ``name`` on the innermost open clock (of
    any thread: a step's backward marks from autograd's device thread);
    nothing without one (with tracing off, only a :func:`timed_clock`
    is ever open)."""
    clocks = _TRACER.clocks()
    if clocks:
        clocks[-1].mark(name)


class _BackwardMark(torch.autograd.Function):
    """The identity on its tensors, whose backward marks a stage as their
    gradients arrive and passes them on unchanged."""

    @staticmethod
    def forward(ctx, name, *tensors):
        ctx.name = name
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        stage(ctx.name)
        return (None, *grads)


def stage_on_backward(name: str, *tensors) -> tuple:
    """``tensors`` as a tuple, with :func:`stage` ``name`` marked where a
    backward reaches them: the start of their producer's adjoint, which
    autograd runs with no Python of the producer's to mark it. Off, the
    same tensor objects, and autograd records no node."""
    if not _TRACER.on:
        return tensors
    return _BackwardMark.apply(name, *tensors)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (tracing on only)."""
    if not _TRACER.on:
        return
    with _TRACER._lock:
        _TRACER.counters[name] = _TRACER.counters.get(name, 0) + int(n)


def records() -> list:
    """The raw span records kept so far (:class:`SpanRecord`)."""
    with _TRACER._lock:
        return list(_TRACER.records)


def snapshot() -> dict:
    """Everything recorded, JSON-able: ``spans`` (by name: count,
    total_s, self_s, max_s), ``stages`` (by owner: ``runs`` read and, by
    stage, the median ms and the count of readings), ``counters``, and
    the raw records kept and dropped. Polls every clock first, so a
    completed last replay is read."""
    _TRACER.poll_all()
    with _TRACER._lock:
        spans = {n: {"count": a[0], "total_s": a[1] * 1e-9,
                     "self_s": a[2] * 1e-9, "max_s": a[3] * 1e-9}
                 for n, a in _TRACER.spans.items()}
        stages = {o: {"runs": st["runs"],
                      "stages": {n: {"median_ms": statistics.median(v),
                                     "count": len(v)}
                                 for n, v in st["stages"].items()}}
                  for o, st in _TRACER.stages.items()}
        return {"enabled": _TRACER.on, "spans": spans, "stages": stages,
                "counters": dict(_TRACER.counters),
                "records_kept": len(_TRACER.records),
                "records_dropped": _TRACER.dropped}


def reset() -> None:
    """Forget every span, reading and counter (the switch stays)."""
    _TRACER.reset()
