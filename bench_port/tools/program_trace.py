"""One run of a cell with the program's own tracing on, reported as
``run.py`` reports it, with the per-layer metrics the program's tracing
feeds (``program_metrics.json``) beside the accepted ones.

    python bench_port/tools/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--program <0|1>]

``--program 1`` (the default) switches the program's tracing on
(``dvren_tpu_torch.utils.trace.enable``) before the driver builds the
program and hands the driver's outcome the program's snapshot taken after
the run (``counters["program"]``); with ``--trace 1`` each reduced
profiler stretch also carries :func:`bench_port.lib.spans.idle_by_span`
of its events. ``--program 0`` runs the cell as ``run.py`` does. The
drivers, the harness and ``BENCHMARK.json`` are used as they are: the
tool wraps them in this process only.

With ``--trace 1`` it also prints, on standard error, one
``program_checks:`` JSON line: the stage clock against the device trace of the same stretch (K2's stage
against K2's kernels, the stages' sum against the busy and window time a
unit), the idle split's parts against the stretch's idle, and the
program's set-up spans against the driver's own clocks around the same
calls (``schedule_build_s``; the orbit's ``renderer built and probed``
mark less the mark before it, against ``posed.setup`` and
``posed.probe``).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

T0 = time.perf_counter()

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_port.lib import harness, spans  # noqa: E402
from bench_port.lib import kernels as K  # noqa: E402
from bench_port.lib import trace as btrace  # noqa: E402

ENTRIES = json.loads((Path(__file__).parent / "program_metrics.json")
                     .read_text())
MARK = re.compile(r": (.+) at ([0-9.]+) s$")


def keep_span_idle():
    """Every stretch reduced in this process also carries its idle split
    over the program's spans (``span_idle``)."""
    reduce = btrace.reduce_trace

    def reduced(events, units):
        red = reduce(events, units)
        if red is not None:
            red.span_idle = spans.idle_by_span(events, units)
        return red

    btrace.reduce_trace = reduced


def checks(spec: dict, outcome, marks: dict) -> dict:
    """The stage clock, the idle split and the set-up spans against the
    device trace and the driver's clocks."""
    red, snap = outcome.reduction, outcome.counters.get("program") or {}
    owner = "fit.step" if spec["driver"] == "fit" else "posed.render"
    got = ((snap.get("stages") or {}).get(owner) or {}).get("stages") or {}
    out = {"stage_ms": {n: v["median_ms"] for n, v in got.items()},
           "stage_readings": {n: v["count"] for n, v in got.items()}}
    if red is not None and red.units:
        per = 1e3 / red.units
        out["busy_ms"] = red.busy_s * per
        out["window_ms"] = red.window_s * per
        out["stages_sum_ms"] = sum(out["stage_ms"].values())
        out["k1_trace_ms"] = red.kernel_s(K.K1) * per
        out["k2_trace_ms"] = red.kernel_s(K.K2) * per
        split = getattr(red, "span_idle", None)
        if split:
            out["idle_by_span_ms"] = {n: s * per
                                      for n, s in split["by_span"].items()}
            out["idle_parts_s"] = sum(split["by_span"].values())
            out["idle_s"] = split["idle_s"]
            out["stretch_idle_s"] = red.window_s - red.busy_s
    sp = snap.get("spans") or {}
    if "schedule_build_s" in outcome.counters:
        out["schedule_build_s"] = outcome.counters["schedule_build_s"]
        out["fit_schedule_s"] = sp.get("fit.schedule", {}).get("total_s")
    if "renderer built and probed" in marks:
        names = list(marks)
        i = names.index("renderer built and probed")
        out["probe_clock_s"] = marks[names[i]] - marks[names[i - 1]]
        out["posed_probe_s"] = sp.get("posed.probe", {}).get("total_s")
        out["posed_setup_s"] = sp.get("posed.setup", {}).get("total_s")
    out["spans"] = {n: {k: v[k] for k in ("count", "total_s", "self_s")}
                    for n, v in sp.items()}
    out["counters"] = snap.get("counters")
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/tools/program_trace.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    spec = harness.workload(args.workload)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["per_layer"] = bench["per_layer"] + ENTRIES
    harness.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: no result", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    marks = {}

    def log(*a):
        text = " ".join(str(x) for x in a)
        m = MARK.search(text)
        if m:
            marks[m.group(1)] = float(m.group(2))
        print(text, file=sys.stderr, flush=True)

    ctx = harness.Context(name=args.workload, spec=spec,
                          config=spec["config_spec"], seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=device, t0=T0, torch=torch, log=log)
    ctx.mark("torch imported, device found")
    if args.program:
        from dvren_tpu_torch.utils import trace

        keep_span_idle()
        trace.enable(True)
    outcome = harness.driver(spec["driver"]).run(ctx)
    if args.program:
        outcome.counters["program"] = trace.snapshot()
    found = harness.forbidden_modules()
    if found:
        print(f"loaded: {', '.join(found)}: no result", file=sys.stderr)
        return 4
    if args.trace:
        print("program_checks: " + json.dumps(checks(spec, outcome, marks)),
              file=sys.stderr, flush=True)
    return harness.report(bench, ctx, outcome,
                          torch.cuda.get_device_name(device),
                          harness.power_limit())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
