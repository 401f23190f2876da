"""One profiler session over a stretch of a run's window, reduced to what
the per-layer readers take: the device's busy time inside the stretch,
its kernels, and the breakdown (the device operations that took most
time, the longest idle gaps by what the host was doing).

The stretch is a ``record_function`` range that starts and ends with a
synchronize, so every device operation of its units (steps or frames)
lies inside it. Times come from the profiler's Chrome trace, where host
ranges and device activity share one clock (microseconds).
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field

MARKER = "bench_port.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
TOP = 10


@dataclass
class Reduction:
    """A traced stretch: its length, the device's busy seconds in it, its
    kernels as (name, seconds), and the breakdown lists."""

    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    units: int = 0

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the kernels whose name holds ``pattern``."""
        return sum(s for n, s in self.kernels if pattern in n)


def short_name(name: str) -> str:
    """A kernel's name without its return type and its argument list (the
    last balanced parenthesis group), at most 160 characters."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:160]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _label(gap, host):
    """What the host was doing over a gap: the host range overlapping it
    most (the shorter one on a tie)."""
    best, key = "host: no profiled range", (0.0, 0.0)
    for s, e, name in host:
        if s >= gap[1]:
            break
        ov = min(e, gap[1]) - max(s, gap[0])
        if ov > 0 and (ov, -(e - s)) > key:
            best, key = name, (ov, -(e - s))
    return best


def reduce_trace(events: list, units: int) -> Reduction | None:
    """Reduce Chrome-trace events to the stretch marked :data:`MARKER`;
    None when the trace holds no such range or no device activity."""
    marks = [e for e in events if e.get("name") == MARKER
             and e.get("cat") == "user_annotation" and "dur" in e]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, kernels = [], []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        a, b = max(s, w0), min(s + d, w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            kernels.append((short_name(e.get("name", "")), (b - a) * 1e-6))
    if not dev:
        return None
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name: dict = {}
    for n, s in kernels:
        by_name[n] = by_name.get(n, 0.0) + s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e.get("name", "")) for e in events
                  if e.get("cat") in HOST_CATS and "dur" in e
                  and e.get("name") != MARKER)
    idle = [[_label(g, host), (g[1] - g[0]) * 1e-6] for g in gaps]
    return Reduction(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                     kernels=kernels, device_ops=[[n, s] for n, s in ops],
                     idle_gaps=idle, units=units)


class Tracer:
    """``with tracer.stretch(units):`` profiles the block under
    :data:`MARKER`; :attr:`reduction` holds the result afterwards. Off
    (``enabled=False``) the block runs untraced."""

    def __init__(self, torch, device, enabled: bool):
        self.torch = torch
        self.device = device
        self.enabled = enabled
        self.reduction = None

    @contextmanager
    def stretch(self, units: int):
        torch = self.torch
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize(self.device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(MARKER):
                yield
                torch.cuda.synchronize(self.device)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.remove(path)
        self.reduction = reduce_trace(events, units)
        self.enabled = False          # one session a run
