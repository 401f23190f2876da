"""The port's tracing (``dvren_tpu_torch/utils/trace.py``) on the CPU, and
its stage clock inside CUDA graphs on the card.

The scene is a 12^3 blob seen by two 32^2 views (a scheduled fit step,
its table on the float32 cell route and on the supercell route) and a
64x32 posed renderer in its split mode. Held:

- tracing off: nothing is recorded (a ``timed_clock`` is read, not
  recorded), no ``record_function`` is entered and no CUDA event is made,
  and the fit step's loss and parameters and the
  posed planes are the bits of tracing on;
- tracing on: the fit step marks its stages in the order the step runs
  them and they partition it; the posed build marks its stages, then the
  tiled render's; spans nest, with their parents, units and self times;
  ``schedule.builds`` counts the schedule builds; the fits' and the
  Renderer's set-up timers are their spans; the snapshot is JSON and
  ``reset()`` empties it;
- the kernel table: every symbol is a ``__global__`` of
  ``dvren_tpu_torch/csrc``, and each substring the benchmark keys a tile
  kernel on matches one symbol of the table;
- on the card: a three-stage graph's stages against the same stages
  timed eagerly, and a recorded fit step's stages against its replay.
"""

import importlib.util
import json
import re
import statistics
import threading
import time
from pathlib import Path

import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch.opt import fit
from dvren_tpu_torch.render import graph as graph_mod
from dvren_tpu_torch.render import tiled
from dvren_tpu_torch.render.posed import PosedRenderer
from dvren_tpu_torch.utils import trace

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_TILED = ("table", "gather", "k1", "compose", "loss", "backward", "k2",
          "slot_reduce", "table_grad", "optimizer")
# the float32 cell route's 32 px views overflow into the windowed
# fallback, whose groups mark the windowed path's stages inside the
# compose and the backward
FIT_STAGES = {"supercell": _TILED,
              "f32": ("table", "gather", "k1", "compose", "eval", "stencil",
                      "k9f", "loss", "backward", "k9b", "eval_grad",
                      "stencil_grad", "k2", "slot_reduce", "table_grad",
                      "optimizer")}
POSED_STAGES = ("raygen", "mask", "lattice", "run_stats", "lanes", "table",
                "gather", "k1", "compose")
# the card's build: one kernel launch after raygen
POSED_KERNEL_STAGES = ("raygen", "build", "table", "gather", "k1", "compose")
ROUTES = {"f32": 1, "supercell": 2}


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing kept."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


@pytest.fixture
def tracing():
    trace.enable(True)


def blob(n=12, device="cpu"):
    z, y, x = torch.meshgrid(*[torch.linspace(0.0, 1.0, n)] * 3,
                             indexing="ij")
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.45) ** 2
    sigma = 12.0 * torch.exp(-r2 / 0.05)
    color = torch.stack([x, y, 1.0 - z], dim=-1)
    return P.DenseGridField(sigma.to(device), color.to(device),
                            bbox_min=(0.0, 0.0, 0.0),
                            bbox_max=(1.0, 1.0, 1.0))


def plan(width=32, height=32, steps=32, dx=0.0):
    f = 1.2 * width
    return P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(
            k=(f, 0.0, width / 2, 0.0, f, height / 2, 0.0, 0.0, 1.0),
            c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=P.SamplingMode.STRATIFIED)))


def fit_step(route, device="cpu"):
    """(field, step, targets) of a two-view scheduled fit step whose table
    takes ``route``."""
    base = plan()
    cams = [P.CameraConfig(k=base.camera.k, c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0,
                                                 0.5, 0, 0, 1, -1.0))
            for dx in (-0.1, 0.1)]
    plans = fit.view_plans(base, cams)
    scheds = [tiled.build_tiled_schedule(p, blob(), quantize="uniform",
                                         cell_scale=ROUTES[route])
              for p in plans]
    merged = tiled.merge_view_schedules(scheds, plans=plans).to(device)
    field = blob(device=device)
    opt = torch.optim.Adam(field.parameters(), lr=5e-2,
                           capturable=torch.device(device).type == "cuda")
    views = (plans, merged,
             lambda f, m: tiled.render_tiled_stack(base, f, m))
    step = fit.make_train_step_scheduled(base, cams, field, opt, views=views)
    targets = torch.rand(2, 32, 32, 3,
                         generator=torch.Generator().manual_seed(5))
    return field, step, targets.to(device)


def posed(device="cpu", fused=None):
    """(renderer, the frames' plans, field) of a 64x32 posed orbit."""
    field = blob(device=device)
    plans = [plan(64, 32, 32, dx) for dx in (0.0, 0.03, -0.03)]
    return (PosedRenderer(plans[0], field, probe_plans=plans, fused=fused),
            plans, field)


def stages(owner):
    return trace.snapshot()["stages"].get(owner, {}).get("stages", {})


# ------------------------------------------------------------ tracing off


def test_off_records_nothing():
    field, step, targets = fit_step("f32")
    step(field, targets)
    r, plans, pf = posed()
    r.render(plans[1], pf)
    with trace.span("outer"):
        trace.stage("k1")
        trace.count("schedule.builds")
    with trace.timed_clock("renderer.staged") as clk:    # read, not recorded
        trace.stage("k1")
    assert set(clk.reading()) == {"k1"}
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["stages"] == {}
    assert snap["counters"] == {} and trace.records() == []
    assert snap["enabled"] is False


def test_off_enters_no_profiler_range_and_makes_no_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("made while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    field, step, targets = fit_step("supercell")
    step(field, targets)
    r, plans, pf = posed()
    r.render(plans[2], pf)
    with trace.clock("owner", "cuda") as clk, trace.span("outer"):
        trace.stage("k1")
    assert clk is None
    with trace.timed("fit.schedule") as t:      # read, not recorded
        time.sleep(0.002)
    assert t.seconds >= 0.002 and trace.records() == []


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fit_step_bits_on_and_off(route):
    out = {}
    for on in (False, True):
        trace.enable(on)
        field, step, targets = fit_step(route)
        losses = [step(field, targets) for _ in range(2)]
        out[on] = (losses, field.sigma.detach().clone(),
                   field.color.detach().clone())
    (la, sa, ca), (lb, sb, cb) = out[False], out[True]
    for a, b in zip([*la, sa, ca], [*lb, sb, cb]):
        assert torch.equal(a, b)


def test_posed_planes_bits_on_and_off():
    got = {}
    for on in (False, True):
        trace.enable(on)
        r, plans, pf = posed()
        planes = r.render(plans[1], pf)
        got[on] = (planes.image, planes.opacity, planes.depth)
    for a, b in zip(got[False], got[True]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- tracing on


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fit_step_stage_order(tracing, route):
    field, step, targets = fit_step(route)
    step(field, targets)
    got = stages("fit.step")
    assert tuple(got) == FIT_STAGES[route]
    assert all(s["count"] == 1 and s["median_ms"] >= 0 for s in got.values())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_fit_step_stages_partition_the_step(tracing, route):
    """The stages' sum is the step's time less the host work before its
    first mark and after its end mark (zero_grad, the checks)."""
    field, step, targets = fit_step(route)
    step(field, targets)                        # the first call builds
    trace.reset()
    t0 = time.perf_counter()
    step(field, targets)
    wall_ms = (time.perf_counter() - t0) * 1e3
    total = sum(s["median_ms"] for s in stages("fit.step").values())
    assert total <= wall_ms
    assert wall_ms - total < max(0.05 * wall_ms, 5.0)


def test_posed_split_stage_order(tracing):
    r, plans, pf = posed()
    for p in plans:
        r.render(p, pf)
    got = stages("posed.render")
    assert tuple(got) == POSED_STAGES
    assert {s["count"] for s in got.values()} == {len(plans)}
    spans = trace.snapshot()["spans"]
    assert spans["posed.probe"]["count"] == 1
    assert spans["posed.render"]["count"] == len(plans)
    assert spans["posed.prepare"]["count"] == len(plans)
    assert spans["posed.check_diag"]["count"] == len(plans)
    units = sorted(rec.unit for rec in trace.records()
                   if rec.name == "posed.prepare")
    assert units == list(range(len(plans)))


def test_spans_nest_with_parents_and_self_time(tracing):
    def worker(parent, out):
        with trace.under(parent), trace.span("child.thread"):
            time.sleep(0.01)
        out.append(True)

    done = []
    with trace.span("outer", unit=7):
        with trace.span("child"):
            time.sleep(0.01)
        parent = trace.current()
        th = threading.Thread(target=worker, args=(parent, done))
        th.start()
        th.join(timeout=10)
        time.sleep(0.005)
    assert done and not th.is_alive()
    recs = {r.name: r for r in trace.records()}
    outer = recs["outer"]
    assert outer.parent is None and outer.unit == 7
    for name in ("child", "child.thread"):
        assert recs[name].parent == outer.id and recs[name].unit == 7
        assert outer.start_ns <= recs[name].start_ns
        assert recs[name].end_ns <= outer.end_ns
    spans = trace.snapshot()["spans"]
    kids = sum((recs[n].end_ns - recs[n].start_ns)
               for n in ("child", "child.thread")) * 1e-9
    assert spans["outer"]["self_s"] == pytest.approx(
        spans["outer"]["total_s"] - kids, abs=1e-9)
    assert spans["child"]["self_s"] == spans["child"]["total_s"]
    assert spans["outer"]["max_s"] == spans["outer"]["total_s"]


def test_spans_land_in_a_profiler_session(tracing):
    """Inside a profiler session a span is a ``dvren.<name>`` range; outside
    one it enters none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"), trace.span("inner"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"dvren.outer", "dvren.inner"} <= names
    entered = []
    real = torch.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    torch.profiler.record_function = spy
    try:
        with trace.span("alone"):
            pass
    finally:
        torch.profiler.record_function = real
    assert entered == [] and trace.snapshot()["spans"]["alone"]["count"] == 1


def test_schedule_builds_count_the_builds(tracing, monkeypatch):
    calls = []
    real = tiled.build_tiled_schedule

    def counted(*args, **kwargs):
        calls.append(threading.get_ident())
        return real(*args, **kwargs)

    monkeypatch.setattr(tiled, "build_tiled_schedule", counted)
    base = plan()
    cams = [P.CameraConfig(k=base.camera.k, c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0,
                                                 0.5, 0, 0, 1, -1.0))
            for dx in (-0.1, 0.0, 0.1)]
    fit._scheduled_views(base, cams, blob(), "tiled")
    snap = trace.snapshot()
    assert snap["counters"]["schedule.builds"] == len(calls) >= 3
    assert snap["spans"]["schedule.build"]["count"] == len(calls)
    recs = trace.records()
    top = [r for r in recs if r.name == "fit.schedule"]
    assert len(top) == 1 and snap["spans"]["schedule.cascade"]["count"] == 1
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "schedule.build":           # pool threads included
            while r.parent is not None and r.name != "fit.schedule":
                r = by_id[r.parent]
            assert r is top[0]
    for name in ("schedule.merge", "schedule.upload", "schedule.cascade"):
        (rec,) = [r for r in recs if r.name == name]
        assert rec.parent == top[0].id


def test_set_up_timers_are_their_spans(tracing):
    base = plan()
    cams = [P.CameraConfig(k=base.camera.k, c2w=base.camera.c2w)]
    res = fit.fit_dense_grid(base, blob(), cams, torch.rand(1, 32, 32, 3),
                             fit.FitConfig(steps=1, target_psnr=None),
                             mode="tiled")
    recs = [r for r in trace.records() if r.name == "fit.schedule"]
    assert len(recs) == 1
    assert res.schedule_build_s == (recs[0].end_ns - recs[0].start_ns) * 1e-9
    r = P.Renderer(P.Context.create(device="cpu"), base,
                   P.RenderOptions(use_tiles=True))
    out = r.forward(blob())
    (note,) = [n for n in out.stats.notes
               if n.startswith("tiled_schedule_build_ms=")]
    (rec,) = [x for x in trace.records()
              if x.name == "renderer.tiled_schedule"]
    assert note == f"tiled_schedule_build_ms={(rec.end_ns - rec.start_ns) * 1e-6:.3f}"


def test_snapshot_is_json_and_reset_empties_it(tracing):
    field, step, targets = fit_step("f32")
    step(field, targets)
    trace.count("schedule.builds", 2)
    snap = json.loads(json.dumps(trace.snapshot()))
    assert snap["counters"]["schedule.builds"] >= 2
    assert snap["stages"]["fit.step"]["runs"] == 1
    assert snap["records_kept"] == len(trace.records())
    trace.reset()
    snap = trace.snapshot()
    assert (snap["spans"], snap["stages"], snap["counters"]) == ({}, {}, {})
    assert trace.records() == [] and snap["enabled"] is True


def test_stage_goes_to_the_innermost_clock(tracing):
    trace.stage("nowhere")                      # no clock open: dropped
    with trace.clock("outer"):
        trace.stage("a")
        with trace.clock("inner"):
            trace.stage("b")
            trace.stage("b")
        trace.stage("c")
        with trace.timed_clock("timed") as clk:
            trace.stage("d")
    snap = trace.snapshot()["stages"]
    assert tuple(snap["outer"]["stages"]) == ("a", "c")
    assert snap["inner"]["stages"]["b"]["count"] == 1   # the two marks sum
    assert snap["timed"]["stages"]["d"]["median_ms"] == clk.reading()["d"]


# ------------------------------------------------------------ the table


def _globals() -> set:
    found = set()
    for path in (ROOT / "dvren_tpu_torch" / "csrc").glob("*.cu*"):
        found.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            path.read_text()))
    return found


def test_kernel_table_symbols_are_csrc_globals():
    assert {k.symbol for k in trace.KERNELS} <= _globals()
    names = [k.name for k in trace.KERNELS]
    assert len(set(names)) == len(names)
    assert set(graph_mod.launch_counts()) == set(names)
    for k in trace.KERNELS:
        assert isinstance(k.wrapper.launches, int)


def _bench_kernels():
    path = ROOT / "bench_port" / "lib" / "kernels.py"
    spec = importlib.util.spec_from_file_location("bench_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("key", ["K1", "K2", "K3", "K4"])
def test_bench_kernel_keys_match_one_symbol(key):
    """A renamed kernel fails here, not as a silent zero in a reader. K4's
    symbol is also K5b's (one kernel templated on the row)."""
    pattern = getattr(_bench_kernels(), key)
    assert len({k.symbol for k in trace.KERNELS
                if pattern in k.symbol}) == 1


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage clock's events time "
                    "the card")
    return torch.device("cuda", 0)


def _toy(x, w):
    trace.stage("matmul")
    y = x @ w
    trace.stage("elementwise")
    for _ in range(20):
        y = torch.tanh(y) * 1.01
    trace.stage("reduce")
    return y.sum(dim=0)


@pytest.mark.cuda
def test_graph_stage_clock_against_eager(cuda_device, tracing):
    """Event nodes recorded into a graph time its stages as events around
    the same stages run eagerly do (the first thing to hold on the card)."""
    x = torch.randn(4096, 2048, device=cuda_device)
    w = torch.randn(2048, 2048, device=cuda_device)
    eager = {n: [] for n in ("matmul", "elementwise", "reduce")}
    for _ in range(5):
        with trace.clock("eager", cuda_device):
            _toy(x, w)
        torch.cuda.synchronize(cuda_device)
    cg = graph_mod.capture(lambda: _toy(x, w), cuda_device).owned_by("toy")
    for _ in range(6):
        cg.replay()
        torch.cuda.synchronize(cuda_device)
    snap = trace.snapshot()["stages"]
    assert snap["toy"]["runs"] == 6
    for name in eager:
        got = snap["toy"]["stages"][name]["median_ms"]
        want = snap["eager"]["stages"][name]["median_ms"]
        assert got > 0 and abs(got - want) <= 0.25 * want + 0.02, name


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_recorded_fit_step_stages(cuda_device, tracing, route):
    field, step, targets = fit_step(route, cuda_device)
    step(field, targets)
    assert step.graph.clock is not None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        step.loss(field, targets)
        end.record()
        torch.cuda.synchronize(cuda_device)
        times.append(start.elapsed_time(end))
    got = stages("fit.step")
    assert tuple(got) == FIT_STAGES[route]
    total = sum(s["median_ms"] for s in got.values())
    assert 0 < total <= statistics.median(times) * 1.05


@pytest.mark.cuda
def test_recorded_posed_frame_stages(cuda_device, tracing):
    r, plans, pf = posed(cuda_device)
    for p in plans * 2:
        r.render(p, pf)
    got = stages("posed.render")
    assert tuple(got) == POSED_KERNEL_STAGES
    assert all(s["median_ms"] > 0 for s in got.values())
