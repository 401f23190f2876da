"""What the program's own tracing (``dvren_tpu_torch/utils/trace.py``)
gives the per-layer readers.

``run.counters["program"]`` is the program's ``trace.snapshot()`` taken
after the window, with the program's tracing switched on before it was
built: its spans (count, total, self time), its stage readings (the
median ms of each device stage a step or frame, by the graph that owns
them: ``fit.step``, ``posed.render``) and its counters.
``run.trace.span_idle`` is :func:`idle_by_span` of the traced stretch:
every idle gap of the device, split over the program's host spans. A
reader that finds nothing to read returns None.
"""

from __future__ import annotations

import bisect

from bench_port.lib.trace import DEVICE_CATS, MARKER, _union

PREFIX = "dvren."
OUTSIDE = "outside"


def idle_by_span(events: list, units: int) -> dict | None:
    """The stretch's idle seconds by the innermost program span
    (``user_annotation`` ranges named ``dvren.<name>``) over each part of
    each gap; parts under none go under :data:`OUTSIDE`. The gaps are
    ``reduce_trace``'s (the stretch less the union of its device
    operations), all of them. Returns {``idle_s``, ``units``, ``by_span``
    (name without the prefix -> seconds, ``outside`` included), ``spans``
    (the names of the program spans in the stretch)}, or None without
    the stretch's range or device activity."""
    marks = [e for e in events if e.get("name") == MARKER
             and e.get("cat") == "user_annotation" and "dur" in e]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s = float(e["ts"])
        a, b = max(s, w0), min(s + float(e["dur"]), w1)
        if b > a:
            dev.append((a, b))
    if not dev:
        return None
    edges = [w0] + [x for iv in _union(dev) for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ranges = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
         e["name"][len(PREFIX):]) for e in events
        if e.get("cat") == "user_annotation" and "dur" in e
        and str(e.get("name", "")).startswith(PREFIX))
    starts = [r[0] for r in ranges]
    by = {OUTSIDE: 0.0}
    for a, b in gaps:
        near = [r for r in ranges[:bisect.bisect_left(starts, b)]
                if r[1] > a]
        cuts = sorted({a, b} | {x for r in near for x in r[:2]
                                if a < x < b})
        for p, q in zip(cuts, cuts[1:]):
            over = [r for r in near if r[0] <= p and r[1] >= q]
            name = (max(over, key=lambda r: (r[0], -r[1]))[2] if over
                    else OUTSIDE)
            by[name] = by.get(name, 0.0) + (q - p) * 1e-6
    idle = sum(b - a for a, b in gaps) * 1e-6
    seen = sorted({r[2] for r in ranges if r[0] < w1 and r[1] > w0})
    return {"idle_s": idle, "units": units, "by_span": by, "spans": seen}


def program(run) -> dict | None:
    """The program's snapshot, or None where the run has none (its
    tracing off, or a program without it)."""
    snap = (run.counters or {}).get("program")
    return snap if isinstance(snap, dict) else None


def stage_ms(run, owner: str, names) -> float | None:
    """The stages ``names`` of ``owner``'s readings, ms a step or frame:
    the sum of each stage's median over the run's readings; None unless
    every one was read."""
    snap = program(run)
    got = (((snap or {}).get("stages") or {}).get(owner) or {}).get(
        "stages") or {}
    if not names or any(n not in got or not got[n].get("count")
                        for n in names):
        return None
    return sum(float(got[n]["median_ms"]) for n in names)


def span_s(run, name: str) -> float | None:
    """Seconds the program spent in span ``name``, over the run."""
    spans = (program(run) or {}).get("spans") or {}
    return float(spans[name]["total_s"]) if name in spans else None


def counter(run, name: str) -> float | None:
    counters = (program(run) or {}).get("counters") or {}
    return float(counters[name]) if name in counters else None


def idle_ms(run, names) -> float | None:
    """The traced stretch's idle under the program spans ``names``
    (innermost), ms a step or frame; None without the split, or where
    none of the spans ran in the stretch."""
    split = getattr(run.trace, "span_idle", None) if run.trace else None
    if not split or not split.get("units"):
        return None
    if not set(names) & set(split["spans"]):
        return None
    by = split["by_span"]
    return sum(by.get(n, 0.0) for n in names) / split["units"] * 1e3
