"""The windowed fit driver: a user fitting a dense grid to multi-view
images through the per-ray sample-and-integrate formulation.

The same set-up, window and check as :mod:`bench_port.drivers.fit` (its
``build``, ``first_steps`` and ``window``; the reference's teacher images
and Adam), on a cell whose ``mode`` is "windowed": the program's normal
path, ``opt/fit.py::_scheduled_views`` then
``make_train_step_scheduled``, builds one ``WindowedStackSchedule`` over
every view's rays (``render/windowed.py::build_stack_schedule``) and
records the step, K9f / K9b and the groups' recompute in the backward
(where the program's rule turns it on) included, as one CUDA graph. A
step built over anything else fails the run.

It logs the schedule that ran: its groups, their budgets, the windowed
samples and whether the groups are recomputed. With ``--trace 1`` it
switches the program's tracing on before the build and hands the
program's ``trace.snapshot()``, taken after the window, to the readers as
``counters["program"]``. ``counters`` also holds K9f's and K9b's frozen
byte counts a step (:mod:`bench_port.counts.windowed`).
"""

from __future__ import annotations

import math

from bench_port.counts import windowed as counts
from bench_port.drivers import fit as F
from bench_port.lib import checks
from bench_port.lib import scene as S
from bench_port.lib.harness import Outcome
from bench_port.lib.trace import Tracer
from bench_port.reference import dense_grid as ref


def schedule_of(views):
    """The merged schedule the step was built over; raises unless it is
    the windowed path's."""
    from dvren_tpu_torch.render import windowed

    sched = views[1]
    if not isinstance(sched, windowed.WindowedStackSchedule):
        raise RuntimeError(f"the step was built over a "
                           f"{type(sched).__name__}, not a "
                           f"WindowedStackSchedule: the cell's mode must be "
                           f"\"windowed\"")
    return sched, windowed._remat(sched.windowed_samples, None)


def run(ctx) -> Outcome:
    torch, dev, tr = ctx.torch, ctx.device, ctx.spec["traffic"]
    sc = S.scene(ctx.config, tr)
    poses = [S.poses(tr)[i] for i in S.order(len(S.poses(tr)), ctx.seed)]
    sigma_t, color_t = S.grid(ctx.config, dev)
    targets = torch.stack([ref.render_view(sigma_t, color_t, sc, c)[0]
                           for c in poses])
    del sigma_t, color_t
    S.settle(torch, dev)
    ctx.mark("teacher images made")

    from dvren_tpu_torch.utils import trace

    trace.reset()
    trace.enable(ctx.trace)
    try:
        field, opt, views, step, build_s = F.build(ctx, targets, sc, poses)
        sched, remat = schedule_of(views)
        ctx.mark("schedule built")
        init = [field.sigma.detach().clone(), field.color.detach().clone()]
        first, m1, p3 = F.first_steps(ctx, field, opt, step, targets)
        ctx.mark("first steps run")
        ctx.log(f"{ctx.name}: {len(poses)} views, windowed: "
                f"{len(sched.groups)} groups of "
                f"{[int(g[1].shape[0]) for g in sched.groups]} rays, "
                f"budgets {[int(g[0]) for g in sched.groups]}, "
                f"{sched.windowed_samples} windowed samples of "
                f"{sched.full_lattice_samples}, {sched.skipped_rays} rays "
                f"skipped, remat {'on' if remat else 'off'}; schedule "
                f"build {build_s:.3f} s")

        tracer = Tracer(torch, dev, ctx.trace)
        steps, secs, losses, t_window = F.window(ctx, field, step, targets,
                                                 tracer)
        setup_s = t_window - ctx.t0
        peak = S.peak(torch, dev)
        program = trace.snapshot() if ctx.trace else None
    finally:
        trace.enable(False)
    lattice = views[0][0].sampling
    n = counts.schedule_steps(sched.groups, sc.t_near, sc.t_far,
                              lattice.dt, lattice.max_steps)
    counters = {
        "capture_ms": (step.graph.capture_ms if step.graph is not None
                       else None),
        "schedule_build_s": build_s,
        "windowed_groups": len(sched.groups),
        "windowed_samples": sched.windowed_samples,
        "processed_steps": n.processed,
        "remat": remat,
        "k9f_bytes": counts.k9f_bytes(n, passes=2 if remat else 1),
        "k9b_bytes": counts.k9b_bytes(n),
    }
    if program is not None:
        counters["program"] = program
    failed = sum(1 for v in losses if not math.isfinite(v))
    ctx.log(f"{ctx.name}: {steps} steps in {secs:.3f} s, loss "
            f"{first[0]:.6g} -> {losses[-1]:.6g}; setup {setup_s:.3f} s; "
            f"{n.processed} processed steps")
    del step, opt, views, field, sched
    S.free(torch, dev)

    prog = {"losses": first[:F.CHECKED_STEPS],
            "grads": [m / (1.0 - ref.ADAM_B1) for m in m1], "params": p3}
    r = ref.adam_fit(init[0], init[1], sc, poses, targets, float(tr["lr"]),
                     F.CHECKED_STEPS)
    gaps = checks.fit_gaps(prog, r, init)
    ctx.log(f"{ctx.name}: losses program {prog['losses']} reference "
            f"{r['losses']}")
    return Outcome(end_to_end={"setup_s": setup_s,
                               ctx.spec["step_metric"]: secs / steps * 1e3},
                   attempted=steps, failed=failed, gaps=gaps,
                   memory_peak_bytes=peak, counters=counters,
                   reduction=tracer.reduction)
