"""The windowed fit's tracing and the benchmark's windowed cell, on the
CPU, and the windowed step recorded with its recompute on the card.

The scene is a 12^3 blob seen by two 32^2 views at 16 stratified steps,
merged into one windowed stack schedule of 256-ray groups (several
groups, so that the stages and counters of a step sum over them). Held:

- tracing off: the windowed step records no stage, span or counter, and
  its loss and parameters are the bits of tracing on, with the groups
  recomputed in the backward and without;
- tracing on: the step marks ``eval``, ``stencil``, ``eval``, ``k9f`` a
  group, ``compose``, then the backward's ``k9b``, ``eval_grad`` and
  ``stencil_grad`` a group, a recomputed group's forward stages again
  before its ``k9b``; each stage's reading is the sum of its intervals
  over the groups; the counters count the renders, groups, samples and
  recomputed groups; ``schedule.windowed`` nests in ``fit.schedule``;
- ``bench_port/counts/windowed.py``: the processed steps and K9f / K9b
  bytes of a two-group schedule against a count of the sampler's own
  masks and the integrator's processed steps, and the K9 symbols against
  the kernel table;
- ``bench_port/drivers/fit_windowed.py`` through ``harness.local_run``
  at the small size: a sound run is correct under the cell's limits, the
  loss over half the views is not, a cell whose mode is not "windowed"
  is refused, and a traced run hands the readers the program's stages
  and counters.
"""

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import dvren_tpu_torch as P  # noqa: E402
from dvren_tpu_torch.ops.integrate import processed_steps, scan_prefix  # noqa: E402
from dvren_tpu_torch.ops.raygen import Rays  # noqa: E402
from dvren_tpu_torch.ops.sampling import generate_samples  # noqa: E402
from dvren_tpu_torch.opt import fit  # noqa: E402
from dvren_tpu_torch.render import windowed  # noqa: E402
from dvren_tpu_torch.render.pipeline import plan_jitter_table  # noqa: E402
from dvren_tpu_torch.utils import trace  # noqa: E402

from bench_port.counts import windowed as counts  # noqa: E402
from bench_port.lib import checks, harness  # noqa: E402
from bench_port.lib import trace as btrace  # noqa: E402

torch.set_num_threads(1)

CELL = "blob64.fit4x512w"
SEED = 2 ** 31 + 613
BLOCK = 256
FORWARD = ("eval", "stencil", "eval", "k9f")
BACKWARD = ("k9b", "eval_grad", "stencil_grad")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing kept."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def blob(n=12, device="cpu"):
    z, y, x = torch.meshgrid(*[torch.linspace(0.0, 1.0, n)] * 3,
                             indexing="ij")
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.45) ** 2
    sigma = 12.0 * torch.exp(-r2 / 0.05)
    color = torch.stack([x, y, 1.0 - z], dim=-1)
    return P.DenseGridField(sigma.to(device), color.to(device))


def base_plan(size=32, steps=16):
    f = 1.2 * size
    return P.Plan.create(P.PlanConfig(
        width=size, height=size, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(
            k=(f, 0.0, size / 2, 0.0, f, size / 2, 0.0, 0.0, 1.0),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=P.SamplingMode.STRATIFIED)))


def cameras(base):
    return [P.CameraConfig(k=base.camera.k, c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0,
                                                 0.5, 0, 0, 1, -1.0))
            for dx in (-0.1, 0.1)]


def stack(base, device="cpu", block=BLOCK):
    plans = fit.view_plans(base, cameras(base))
    return plans, windowed.build_stack_schedule(
        plans, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), block=block,
        jitter=plan_jitter_table(base), device=device)


def windowed_step(remat, device="cpu"):
    """(field, step, targets, schedule) of a two-view windowed fit step
    whose groups are recomputed in the backward where ``remat``."""
    base = base_plan()
    plans, sched = stack(base, device)
    field = blob(device=device)
    opt = torch.optim.Adam(field.parameters(), lr=5e-2,
                           capturable=torch.device(device).type == "cuda")

    def render(f, s):
        return windowed.render_windowed_stack(base, f, s, remat=remat)

    step = fit.make_train_step_scheduled(base, cameras(base), field, opt,
                                         mode="windowed",
                                         views=(plans, sched, render))
    targets = torch.rand(2, 32, 32, 3,
                         generator=torch.Generator().manual_seed(5))
    return field, step, targets.to(device), sched


def expected_marks(groups: int, remat: bool) -> list:
    back = (FORWARD if remat else ()) + BACKWARD
    return (list(FORWARD) * groups + ["compose", "loss", "backward"]
            + list(back) * groups + ["optimizer"])


# ----------------------------------------------------------- the program


def test_off_records_nothing():
    field, step, targets, _ = windowed_step(remat=True)
    step(field, targets)
    fit._scheduled_views(base_plan(), cameras(base_plan()), blob(),
                         "windowed")
    snap = trace.snapshot()
    assert (snap["spans"], snap["stages"], snap["counters"]) == ({}, {}, {})
    assert trace.records() == []


@pytest.mark.parametrize("remat", [False, True], ids=["kept", "remat"])
def test_step_bits_on_and_off(remat):
    out = {}
    for on in (False, True):
        trace.enable(on)
        field, step, targets, _ = windowed_step(remat)
        losses = [step(field, targets) for _ in range(2)]
        out[on] = [*losses, field.sigma.detach().clone(),
                   field.color.detach().clone()]
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)


def test_remat_gives_the_bits_of_kept_residuals():
    out = []
    for remat in (False, True):
        field, step, targets, _ = windowed_step(remat)
        losses = [step(field, targets) for _ in range(2)]
        out.append([*losses, field.sigma.detach(), field.color.detach()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [False, True], ids=["kept", "remat"])
def test_stages_and_counters(remat):
    trace.enable(True)
    field, step, targets, sched = windowed_step(remat)
    groups = len(sched.groups)
    assert groups >= 3
    step(field, targets)
    snap = trace.snapshot()
    got = snap["stages"]["fit.step"]["stages"]
    assert tuple(got) == ("eval", "stencil", "k9f", "compose", "loss",
                          "backward", "k9b", "eval_grad", "stencil_grad",
                          "optimizer")
    assert all(s["count"] == 1 and s["median_ms"] >= 0 for s in got.values())
    assert snap["counters"] == {
        "windowed.renders": 1, "windowed.groups": groups,
        "windowed.samples": sched.windowed_samples,
        **({"windowed.remat_groups": groups} if remat else {})}


@pytest.mark.parametrize("remat", [False, True], ids=["kept", "remat"])
def test_stage_readings_sum_over_groups(remat, monkeypatch):
    """Every group marks its stages (a recomputed one its forward's again
    before its ``k9b``), and a stage's reading is the sum of the intervals
    from each of its marks to the next."""
    seen = []
    reading = trace._Clock.reading

    def kept(self):
        seen.append((list(self.marks), self.end))
        return reading(self)

    monkeypatch.setattr(trace._Clock, "reading", kept)
    trace.enable(True)
    field, step, targets, sched = windowed_step(remat)
    step(field, targets)
    (marks, end), = seen
    assert [n for n, _ in marks] == expected_marks(len(sched.groups), remat)
    stamps = [t for _, t in marks] + [end]
    sums = {}
    for (name, a), b in zip(marks, stamps[1:]):
        sums[name] = sums.get(name, 0.0) + (b - a) * 1e-6
    got = trace.snapshot()["stages"]["fit.step"]["stages"]
    assert {n: s["median_ms"] for n, s in got.items()} == sums


def test_schedule_span_nests_in_fit_schedule():
    trace.enable(True)
    base = base_plan()
    _, sched, _ = fit._scheduled_views(base, cameras(base), blob(),
                                       "windowed")
    assert isinstance(sched, windowed.WindowedStackSchedule)
    recs = {r.name: r for r in trace.records()}
    assert recs["schedule.windowed"].parent == recs["fit.schedule"].id


# ------------------------------------------------------ the frozen counts


def _hand_count(base, sched, field):
    """(processed steps by the integrator's own rule, the masks' live
    steps, rays, slots) of every group, from the sampler's lattice."""
    proc = live = rays = slots = 0
    for budget, ids, ke, jit, o, d, tf in sched.groups:
        m = int(ids.shape[0])
        rays_g = Rays(origins=o, directions=d,
                        t_near=torch.full((m,), float(base.t_near)),
                        t_far=tf, pixel_ids=ids)
        lat = generate_samples(base, rays_g, jitter=jit, step_offset=ke,
                               num_steps=budget)
        sigma = field.sigma_at_planes(*lat.position_planes) * lat.mask
        od = torch.clamp_min(sigma * lat.dt, 0.0)
        p = torch.exp(-scan_prefix(od))
        t_before = torch.cat([torch.ones_like(p[:, :1]), p[:, :-1]], dim=1)
        proc += int(processed_steps(lat.mask, t_before).sum())
        live += int(lat.mask.sum())
        rays += m
        slots += int(lat.mask.numel())
    return proc, live, rays, slots


def test_k9_counts_match_a_hand_count():
    base = base_plan()
    _, sched = stack(base, block=1024)
    assert len(sched.groups) == 2
    proc, live, rays, slots = _hand_count(base, sched, blob())
    assert proc == live        # the blob stops no ray early
    n = counts.schedule_steps(sched.groups, base.t_near, base.t_far,
                              base.sampling.dt, base.sampling.max_steps)
    assert (n.processed, n.rays, n.slots) == (proc, rays, slots)
    reads = proc * (5 * 4 + 1)
    assert counts.k9f_bytes(n) == reads + rays * 4 + rays * 8 * 4
    assert counts.k9f_bytes(n, passes=2) == 2 * counts.k9f_bytes(n)
    assert counts.k9b_bytes(n) == reads + rays * 3 * 4 + slots * 4 * 4


@pytest.mark.parametrize("key", ["K9F", "K9B"])
def test_k9_keys_match_one_symbol(key):
    pattern = getattr(counts, key)
    assert len({k.symbol for k in trace.KERNELS
                if pattern in k.symbol}) == 1


# --------------------------------------------------------- the driver


def small(mode="windowed") -> dict:
    spec = harness.workload(CELL)
    spec["config_spec"]["grid"]["n"] = 12
    spec["traffic"].update(width=32, height=32, steps=16, sync_every=4,
                           mode=mode)
    spec["traffic"]["orbit"]["count"] = 2
    return spec


def driven(spec, trace_on=False):
    return harness.local_run(CELL, spec, SEED, 0.05, "cpu", trace=trace_on,
                             log=lambda *a: None)


@pytest.mark.parametrize("fault, ok", [(None, True), ("half_batch", False)])
def test_driver_against_the_reference(fault, ok, monkeypatch):
    if fault == "half_batch":
        def half(pred, target):
            n = pred.shape[0] // 2
            return torch.mean((pred[:n] - target[:n]) ** 2)

        monkeypatch.setattr(fit, "mse", half)
    spec = small()
    out = driven(spec)
    good, _ = checks.verdict(out.gaps, spec["limits"])
    assert (good and out.failed == 0 and out.attempted > 0) == ok
    assert out.counters["windowed_groups"] >= 1
    assert out.counters["k9f_bytes"] > out.counters["processed_steps"] > 0


def test_cell_limits_cover_the_fit_checks():
    limits = harness.workload(CELL)["limits"]
    assert set(limits) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(v > 0 for v in limits.values())


def test_cell_config_is_blob64_in_the_windowed_formulation():
    """The cell's configuration, ``blob64w``: ``blob64``'s field, geometry
    and reference under upstream's staged per-ray source, stating the
    formulation the cell's traffic runs."""
    spec = harness.workload(CELL)
    own = spec["config_spec"]
    base = harness.load_json(harness.BENCH / "configs" / "blob64.json")
    assert own["name"] == spec["config"] == "blob64w"
    assert own["formulation"].split(":")[0] == spec["traffic"]["mode"]
    assert own["source"] != base["source"] and own["reduced"] == []
    same = {k: v for k, v in own.items()
            if k not in ("name", "source", "formulation")}
    assert same == {k: v for k, v in base.items()
                    if k not in ("name", "source")}


def test_driver_refuses_a_schedule_that_is_not_windowed():
    with pytest.raises(RuntimeError, match="WindowedStackSchedule"):
        driven(small(mode="tiled"))


def test_traced_driver_feeds_the_readers(monkeypatch):
    """With ``--trace 1`` the program's stages and counters reach the
    readers (the profiler's stretch needs the card: a plain block here)."""
    from contextlib import contextmanager

    @contextmanager
    def plain(self, units):
        yield

    monkeypatch.setattr(btrace.Tracer, "stretch", plain)
    out = driven(small(), trace_on=True)
    assert trace.snapshot()["enabled"] is False     # switched off after
    json.dumps(out.counters["program"])
    run = SimpleNamespace(trace=None, counters=out.counters,
                          device_kind="cpu")
    for name in ("eval_ms.windowed", "eval_grad_ms.windowed"):
        assert harness.reader(name).read(run) > 0
    assert harness.reader("remat_groups.windowed").read(run) == 0.0
    for name in ("k9f_roofline.windowed", "k9b_roofline.windowed",
                 "step_kernels.windowed", "device_idle_pct.windowed"):
        assert harness.reader(name).read(run) is None
    assert "schedule.windowed" in out.counters["program"]["spans"]


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step is recorded as a CUDA "
                    "graph and its stage clock's events time the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["kept", "remat"])
def test_recorded_windowed_step(cuda_device, remat):
    """The step records with its groups recomputed in the backward, and
    replays the eager step's bits; traced, its stages and counters. Each
    group's evaluation (a recomputed group's again) goes through the
    packed-stencil kernels (``dense.kernel_evals``)."""
    field, step, targets, sched = windowed_step(remat, cuda_device)
    eager_f, _, _, _ = windowed_step(remat, cuda_device)
    eager_opt = torch.optim.Adam(eager_f.parameters(), lr=5e-2,
                                 capturable=True)
    base = base_plan()
    body = fit._step_body(lambda f: windowed.render_windowed_stack(
        base, f, sched, remat=remat), eager_opt, 0.0)
    for _ in range(3):
        got = step(field, targets)
        want = body(eager_f, targets)
        assert torch.equal(got, want)
    assert torch.equal(field.sigma, eager_f.sigma)
    assert step.graph.launches["integrate"] == len(sched.groups) * (
        2 if remat else 1)
    assert step.graph.launches["integrate_bwd"] == len(sched.groups)
    assert step.graph.launches["packed_eval"] == len(sched.groups) * (
        2 if remat else 1)
    assert step.graph.launches["packed_eval_bwd"] == len(sched.groups)

    trace.enable(True)
    field, step, targets, sched = windowed_step(remat, cuda_device)
    for _ in range(4):
        step.loss(field, targets)
    torch.cuda.synchronize(cuda_device)
    snap = trace.snapshot()
    got = snap["stages"]["fit.step"]["stages"]
    assert set(got) == {"eval", "stencil", "k9f", "compose", "loss",
                        "backward", "k9b", "eval_grad", "stencil_grad",
                        "optimizer"}
    assert all(s["median_ms"] > 0 for s in got.values())
    # recorded twice (the warm-up and the recording), replayed since
    assert snap["counters"]["windowed.renders"] == 2
    assert snap["counters"].get("windowed.remat_groups", 0) == (
        2 * len(sched.groups) if remat else 0)
    assert snap["counters"]["dense.kernel_evals"] == 2 * len(sched.groups) * (
        2 if remat else 1)
    assert math.isfinite(float(step.loss(field, targets)))
