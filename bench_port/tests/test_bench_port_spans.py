"""The readers of the program's own tracing (``lib/spans.py``, the metric
files ``tools/program_metrics.json`` names) on made-up traces and
snapshots, and whole small CPU runs of each driver with the program's
tracing on."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port.lib import harness, spans, trace
from bench_port.tests.test_bench_port_faults import SEED, small
from bench_port.tests.test_bench_port_trace import ev

ROOT = Path(__file__).resolve().parents[2]
ENTRIES = json.loads((ROOT / "bench_port" / "tools" /
                      "program_metrics.json").read_text())
NAMES = [m["name"] for m in ENTRIES]

# stretch [100, 200]; device busy [100, 110], [130, 140], [150, 160],
# [190, 195]; idle [110, 130], [140, 150], [160, 190], [195, 200] = 65 us
EVENTS = [
    ev("user_annotation", trace.MARKER, 100.0, 100.0),
    ev("kernel", "k_a", 95.0, 15.0),
    ev("kernel", "k_b", 130.0, 10.0),
    ev("gpu_memcpy", "Memcpy DtoH", 150.0, 10.0),
    ev("kernel", "k_c", 190.0, 5.0),
    ev("user_annotation", "dvren.posed.render", 105.0, 80.0),   # to 185
    ev("user_annotation", "dvren.graph.replay", 112.0, 10.0),   # to 122
    ev("user_annotation", "dvren.posed.clone", 165.0, 10.0),    # to 175
    ev("user_annotation", "dvren.schedule.build", 300.0, 10.0),  # after
    ev("cpu_op", "aten::copy_", 140.0, 5.0),
]


def test_idle_by_span_splits_every_gap():
    split = spans.idle_by_span(EVENTS, units=2)
    by = {n: round(s * 1e6, 9) for n, s in split["by_span"].items()}
    # [110, 130]: render 110-112, replay 112-122, render 122-130;
    # [140, 150]: render; [160, 190]: render 160-165 and 175-185, clone
    # 165-175, outside 185-190; [195, 200]: outside
    assert by == {"posed.render": 35.0, "graph.replay": 10.0,
                  "posed.clone": 10.0, "outside": 10.0}
    assert split["idle_s"] == pytest.approx(65e-6)
    assert sum(split["by_span"].values()) == pytest.approx(
        split["idle_s"], rel=1e-12)
    red = trace.reduce_trace(EVENTS, units=2)
    assert red.window_s - red.busy_s == pytest.approx(split["idle_s"],
                                                      rel=1e-9)
    assert split["spans"] == ["graph.replay", "posed.clone", "posed.render"]


def test_idle_by_span_nothing_to_split():
    assert spans.idle_by_span(EVENTS[1:], units=2) is None
    assert spans.idle_by_span([EVENTS[0], EVENTS[5]], units=2) is None


def test_idle_readers():
    red = trace.reduce_trace(EVENTS, units=2)
    red.span_idle = spans.idle_by_span(EVENTS, units=2)
    run = SimpleNamespace(trace=red, counters={}, device_kind="")
    # render and its children: 35 + 10 + 10 us over 2 frames
    assert harness.reader("render_idle_ms.orbit").read(run) == \
        pytest.approx(0.0275)
    assert harness.reader("launch_idle_ms.flagship").read(run) == \
        pytest.approx(0.005)
    bare = trace.reduce_trace(EVENTS[:5], units=2)     # no program spans
    bare.span_idle = spans.idle_by_span(EVENTS[:5], units=2)
    for r in (SimpleNamespace(trace=bare, counters={}),
              SimpleNamespace(trace=None, counters={}),
              SimpleNamespace(trace=trace.reduce_trace(EVENTS, 2),
                              counters={})):
        assert harness.reader("render_idle_ms.orbit").read(r) is None


SNAP = {"spans": {"fit.schedule": {"count": 1, "total_s": 1.25,
                                   "self_s": 0.5, "max_s": 1.25},
                  "posed.probe": {"count": 1, "total_s": 4.5,
                                  "self_s": 4.5, "max_s": 4.5}},
        "stages": {"fit.step": {"runs": 3, "stages": {
            n: {"median_ms": v, "count": 3} for n, v in (
                ("table", 0.5), ("gather", 2.0), ("k1", 0.8),
                ("slot_reduce", 1.5), ("table_grad", 0.25))}},
            "posed.render": {"runs": 9, "stages": {
                n: {"median_ms": 1.0 + i, "count": 9} for i, n in enumerate(
                    ("raygen", "mask", "lattice", "run_stats", "lanes",
                     "k1"))}}},
        "counters": {"schedule.builds": 5}}


def test_snapshot_readers():
    run = SimpleNamespace(trace=None, counters={"program": SNAP})
    want = {"table_ms.fit": 0.75, "gather_ms.fit": 2.0,
            "slot_reduce_ms.fit": 1.5, "table_ms.flagship": 0.75,
            "gather_ms.flagship": 2.0, "build_ms.orbit": 15.0,
            "run_stats_ms.orbit": 4.0, "schedule_span_s.fit": 1.25,
            "schedule_builds.fit": 5.0, "probe_s.orbit": 4.5}
    for name, value in want.items():
        assert harness.reader(name).read(run) == pytest.approx(value), name
    empty = SimpleNamespace(trace=None, counters={})
    for name in NAMES:
        assert harness.reader(name).read(empty) is None, name


def test_entries_name_their_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in ENTRIES:
        assert m["moves"] in e2e and m["better"] == "lower"
        assert (ROOT / "bench_port" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("cell", ["blob64.fit8x96", "blob64.orbit512"])
def test_small_cpu_run_feeds_the_readers(cell):
    """A whole small CPU run with the program's tracing on: every reader
    of the program's snapshot for the cell finds its number."""
    from dvren_tpu_torch.utils import trace as ptrace

    ptrace.reset()
    ptrace.enable(True)
    try:
        out = harness.local_run(cell, small(cell), SEED, 0.05, "cpu",
                                log=lambda *a: None)
        out.counters["program"] = ptrace.snapshot()
    finally:
        ptrace.enable(False)
        ptrace.reset()
    run = SimpleNamespace(trace=None, counters=out.counters)
    for m in ENTRIES:
        if cell in m["workloads"] and m["source"] != "device_trace":
            v = harness.reader(m["name"]).read(run)
            assert v is not None and v >= 0, m["name"]
