"""The harness: one cell, run once, as ``run.py`` is called.

It finds everything by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its driver in
``drivers/<driver>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``; ``BENCHMARK.json`` at the checkout's root says
which metrics a cell reports. A driver runs the set-up, the measured
window and the comparison with the plain reference, and returns an
:class:`Outcome`; the harness prints the result line.

Exit codes: 0 a result was printed; 2 a bad argument or an unknown cell;
3 no CUDA device, or fewer than the cell asks for; 4 JAX or the JAX
package was loaded; anything else an error in the run (a traceback).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dvren_tpu")


@dataclass
class Context:
    """What a driver gets: the cell, its configuration, the run's seed,
    length and trace switch, the device, and the process's start time."""

    name: str
    spec: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    torch: object = None
    log: object = None

    def mark(self, what: str) -> None:
        """Log ``what`` with the seconds since the process started."""
        import time

        self.log(f"{self.name}: {what} at {time.perf_counter() - self.t0:.3f} s")


@dataclass
class Outcome:
    """What a driver returns. ``end_to_end``: every end-to-end metric it
    measured, by name. ``gaps``: the numbers compared with the
    reference. ``counters``: what the per-layer readers take besides the
    trace (program counters and spans, host clocks, frozen counts)."""

    end_to_end: dict
    attempted: int
    failed: int
    gaps: dict
    memory_peak_bytes: int
    counters: dict = field(default_factory=dict)
    reduction: object = None


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def workload(name: str) -> dict:
    """A cell's file, with its configuration loaded under
    ``config_spec``."""
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    spec["config_spec"] = load_json(BENCH / "configs" / f"{spec['config']}.json")
    return spec


def _load_file(path: Path, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"bench_port.drivers.{name}")


def reader(metric: str):
    return _load_file(BENCH / "metrics" / f"{metric}.py",
                      f"bench_port_metric_{metric.replace('.', '_')}")


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end entries, per-layer entries) this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".bench_port_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def layer_values(metrics: list, outcome: Outcome, kind: str) -> dict:
    """Each per-layer metric its reader finds something for."""
    run = SimpleNamespace(trace=outcome.reduction, counters=outcome.counters,
                          device_kind=kind)
    out = {}
    for m in metrics:
        v = reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    err = sys.stderr
    try:
        spec = workload(args.workload)
    except FileNotFoundError as exc:
        print(f"unknown cell {args.workload!r}: {exc}", file=err)
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    cache_dirs()
    import torch

    chips = int(spec.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA device for {args.workload} (needs {chips}; "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}): no result", file=err)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(name=args.workload, spec=spec, config=spec["config_spec"],
                  seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t0=t0, torch=torch,
                  log=lambda *a: print(*a, file=err, flush=True))
    ctx.mark("torch imported, device found")
    outcome = driver(spec["driver"]).run(ctx)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)} (JAX or the JAX "
              f"package): no result", file=err)
        return 4
    return report(bench, ctx, outcome, torch.cuda.get_device_name(device),
                  power_limit())


def report(bench: dict, ctx: Context, outcome: Outcome, kind: str,
           power: str | None) -> int:
    """Print the checks on standard error and the result line last on
    standard output."""
    from bench_port.lib.checks import verdict

    correct, checks = verdict(outcome.gaps, ctx.spec.get("limits", {}))
    correct = correct and outcome.failed == 0 and outcome.attempted > 0
    e2e, layer = cell_metrics(bench, ctx.name)
    if ctx.trace:
        metrics = layer_values(layer, outcome, kind)
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in e2e}
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(outcome.memory_peak_bytes),
              "power_limit": power}
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device}
    red = outcome.reduction
    if ctx.trace and red is not None:
        device["busy_s"] = red.busy_s
        device["window_s"] = red.window_s
        line["breakdown"] = {"device_ops": red.device_ops,
                             "idle_gaps": red.idle_gaps}
    line["checks"] = {k: {"value": _number(d["value"]), "limit": d["limit"]}
                      for k, d in checks.items()}
    print(f"correct: {bool(correct)}", file=sys.stderr)
    for k, d in checks.items():
        print(f"check {k}: {d['value']!r} limit {d['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def local_run(name: str, spec: dict, seed: int, seconds: float, device,
              trace: bool = False, log=None) -> Outcome:
    """One run of a cell's driver in this process, on ``device``, without
    the look for a chip: for the tests (at small sizes on the CPU) and
    the limit readings (``tools/limits.py``). ``spec`` as
    :func:`workload` gives it."""
    import time

    import torch

    ctx = Context(name=name, spec=spec, config=spec["config_spec"],
                  seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device), t0=time.perf_counter(),
                  torch=torch,
                  log=log or (lambda *a: print(*a, file=sys.stderr,
                                               flush=True)))
    return driver(spec["driver"]).run(ctx)
