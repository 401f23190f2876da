"""The trace reduction and the per-layer readers on a made-up trace, and
one traced run of a cell on the card."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench_port.lib import harness, trace

ROOT = Path(__file__).resolve().parents[2]


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("user_annotation", trace.MARKER, 100.0, 100.0),
    ev("kernel", "void (anonymous namespace)::tile_forward_kernel<1, false>"
       "(float const*, int)", 105.0, 10.0),
    ev("kernel", "void (anonymous namespace)::tile_backward_kernel<1, false,"
       " false>(float const*)", 110.0, 30.0),           # overlaps K1
    ev("gpu_memcpy", "Memcpy DtoD", 150.0, 5.0),
    ev("kernel", "void packed_table_kernel(float const*)", 170.0, 20.0),
    ev("kernel", "void tile_forward_kernel<1, false>(float const*)", 90.0,
       20.0),                                           # starts before
    ev("cuda_runtime", "cudaGraphLaunch", 139.0, 12.0),
    ev("cuda_runtime", "cudaStreamSynchronize", 156.0, 40.0),
]


def test_reduce():
    red = trace.reduce_trace(EVENTS, units=2)
    assert red.window_s == pytest.approx(100e-6)
    # device busy: [100, 140] + [150, 155] + [170, 190] = 65 us
    assert red.busy_s == pytest.approx(65e-6)
    assert red.kernel_s("tile_forward_kernel") == pytest.approx(20e-6)
    assert red.kernel_s("tile_backward_kernel") == pytest.approx(30e-6)
    assert red.device_ops[0][0] == "(anonymous namespace)::tile_backward_kernel<1, false, false>"
    # gaps [155, 170], [140, 150], [190, 200], each named by the host
    # range that covers most of it
    assert [(n, round(s * 1e6)) for n, s in red.idle_gaps] == [
        ("cudaStreamSynchronize", 15), ("cudaGraphLaunch", 10),
        ("cudaStreamSynchronize", 10)]


def test_no_marker_no_reduction():
    assert trace.reduce_trace(EVENTS[1:], units=2) is None


def test_readers():
    red = trace.reduce_trace(EVENTS, units=2)
    run = SimpleNamespace(trace=red, counters={
        "k1_bytes": 3.35e12 * 5e-6, "k2_bytes": 3.35e12 * 3e-6,
        "step_ops": 67e12 * 10e-6, "capture_ms": 12.5,
        "schedule_build_s": 1.5}, device_kind="NVIDIA H100 80GB HBM3")
    val = {n: harness.reader(n).read(run) for n in (
        "device_idle_pct.fit", "step_kernels.fit", "k1_roofline.fit",
        "k2_roofline.fit", "step_mfu.fit", "capture_ms.fit",
        "schedule_build_s.fit", "frame_other_ms.orbit")}
    assert val["device_idle_pct.fit"] == pytest.approx(35.0)
    assert val["step_kernels.fit"] == 2.0
    # K1: 10 us a step (its part inside the stretch) against a 5 us bound
    assert val["k1_roofline.fit"] == pytest.approx(50.0)
    assert val["k2_roofline.fit"] == pytest.approx(20.0)
    assert val["step_mfu.fit"] == pytest.approx(20.0)
    assert val["capture_ms.fit"] == 12.5
    assert val["schedule_build_s.fit"] == 1.5
    # every kernel but K1 and K3: K2's 30 us over 2 frames
    assert val["frame_other_ms.orbit"] == pytest.approx(0.015)
    empty = SimpleNamespace(trace=None, counters={}, device_kind="")
    assert all(harness.reader(n).read(empty) is None for n in (
        "device_idle_pct.fit", "k1_roofline.fit", "step_mfu.fit",
        "frame_kernels.orbit"))


@pytest.mark.cuda
def test_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "blob64.fit8x96",
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert "k2_roofline.flagship" in line["metrics"]
    assert 0 < line["metrics"]["k2_roofline.flagship"]["value"] <= 100
