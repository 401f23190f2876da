"""The fit driver: a user fitting a dense grid to multi-view images.

The run's seed orders the views. Set-up makes the configuration's grid
on the device and renders the teacher images from it with the plain reference (the same tensors go to
the program and to the check), then builds the program's training step
once: a dense field at the cell's initial value, ``torch.optim.Adam``
(capturable on the card), the merged multi-view tile schedule and
``opt/fit.py::make_train_step_scheduled``, which records the step as one
CUDA graph at its first call. The first ``sync_every`` steps go through
the window's own call, ``step.loss(field, targets)``, and are set-up; the
check keeps Adam's first moment after step 1 and the parameters after
step 3. The window then replays steps in a closed loop, copying the
losses to the host every ``sync_every`` steps (as the fit loop does),
until its time is up; it ends in a synchronize.

Reported: the cell's ``step_metric`` (``train_step_ms`` or
``flagship_step_ms``), the window's host time over its steps, and
``setup_s``. The check runs after the window: the reference takes three
Adam steps of its own from the same start and the numbers of
:func:`bench_port.lib.checks.fit_gaps` are compared.
"""

from __future__ import annotations

import math

from bench_port.counts import tiles as counts
from bench_port.lib import checks
from bench_port.lib import scene as S
from bench_port.lib.harness import Outcome
from bench_port.lib.trace import Tracer
from bench_port.reference import dense_grid as ref

CHECKED_STEPS = 3


def build(ctx, targets, sc, poses):
    """The program's field, optimizer, merged views and step, and the
    host seconds the schedule build and the step's construction took."""
    torch, dev, tr = ctx.torch, ctx.device, ctx.spec["traffic"]
    import dvren_tpu_torch as P
    from dvren_tpu_torch.opt import fit

    ctx.mark("program imported")
    n = int(ctx.config["grid"]["n"])
    init = float(tr["init"])
    field = P.DenseGridField(
        torch.full((n, n, n), init, dtype=torch.float32, device=dev),
        torch.full((n, n, n, 3), init, dtype=torch.float32, device=dev),
        bbox_min=sc.bbox_min, bbox_max=sc.bbox_max)
    plan = S.plan(P, sc, poses[0])
    cams = [P.CameraConfig(k=plan.camera.k, c2w=tuple(c)) for c in poses]
    opt = torch.optim.Adam(field.parameters(), lr=float(tr["lr"]),
                           betas=(ref.ADAM_B1, ref.ADAM_B2),
                           eps=ref.ADAM_EPS,
                           capturable=dev.type == "cuda")
    t = S.clock()
    views = fit._scheduled_views(plan, cams, field, tr["mode"])
    step = fit.make_train_step_scheduled(plan, cams, field, opt,
                                         mode=tr["mode"], sigma_min=0.0,
                                         views=views)
    return field, opt, views, step, S.clock() - t


def first_steps(ctx, field, opt, step, targets):
    """Steps 1 .. sync_every (at least 3) through ``step.loss``: (their
    losses, Adam's first moments after step 1, the parameters after step
    3)."""
    torch = ctx.torch
    params = [field.sigma, field.color]
    pending, m1, p3 = [], None, None
    for i in range(max(int(ctx.spec["traffic"]["sync_every"]),
                       CHECKED_STEPS)):
        pending.append(step.loss(field, targets).clone())
        if i == 0:
            m1 = [opt.state[p]["exp_avg"].clone() for p in params]
        if i == CHECKED_STEPS - 1:
            p3 = [p.detach().clone() for p in params]
    return torch.stack(pending).cpu().tolist(), m1, p3


def window(ctx, field, step, targets, tracer):
    """Closed-loop steps for ``ctx.seconds``: (steps, seconds, losses).
    With tracing on, one block of ``sync_every`` steps past the middle
    runs inside the profiler."""
    torch, dev = ctx.torch, ctx.device
    k = int(ctx.spec["traffic"]["sync_every"])

    def block():
        out = [step.loss(field, targets).clone() for _ in range(k)]
        return torch.stack(out).cpu().tolist()

    losses, traced = [], not ctx.trace
    S.sync(torch, dev)
    S.steady()
    t0 = S.clock()
    while True:
        if not traced and S.clock() - t0 >= ctx.seconds / 2:
            with tracer.stretch(k):
                losses += block()
            traced = True
        else:
            losses += block()
        if traced and S.clock() - t0 >= ctx.seconds:
            break
    S.sync(torch, dev)
    return len(losses), S.clock() - t0, losses, t0


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

    field, opt, views, step, build_s = build(ctx, targets, sc, poses)
    ctx.mark("schedule built")
    init = [field.sigma.detach().clone(), field.color.detach().clone()]
    first, m1, p3 = first_steps(ctx, field, opt, step, targets)
    ctx.mark("first steps run")
    sched = views[1].sched
    ctx.log(f"{ctx.name}: {len(poses)} views, tile_px {sched.tile_px}, "
            f"cell_scale {sched.cell_scale}, groups "
            f"{[(n, nc, nb) for n, nc, nb in sched.tiles.shapes]}, "
            f"{sched.tiled_samples} live samples, fallback rays "
            f"{sched.fallback_rays}; schedule build {build_s:.3f} s")

    tracer = Tracer(torch, dev, ctx.trace)
    steps, secs, losses, t_window = window(ctx, field, step, targets, tracer)
    setup_s = t_window - ctx.t0
    peak = S.peak(torch, dev)
    cols = 108 if sched.cell_scale == 2 else 32
    shapes = tuple(tuple(int(v) for v in s) for s in sched.tiles.shapes)
    counters = {
        "capture_ms": (step.graph.capture_ms if step.graph is not None
                       else None),
        "schedule_build_s": build_s,
        "k1_bytes": counts.k1_bytes(shapes, sched.subs, cols),
        "k2_bytes": counts.k2_bytes(shapes, sched.subs, cols),
        "step_ops": counts.step_ops(int(sched.tiled_samples),
                                    sched.cell_scale == 2),
    }
    failed = sum(1 for v in losses if not math.isfinite(v))
    ctx.log(f"{ctx.name}: {steps} steps in {secs:.3f} s, loss "
            f"{first[0]:.6g} -> {losses[-1]:.6g}; setup {setup_s:.3f} s")
    del step, opt, views, field
    S.free(torch, dev)

    prog = {"losses": first[:CHECKED_STEPS],
            "grads": [m / (1.0 - ref.ADAM_B1) for m in m1], "params": p3}
    r = ref.adam_fit(init[0], init[1], sc, poses, targets, float(tr["lr"]),
                     CHECKED_STEPS)
    gaps = checks.fit_gaps(prog, r, init)
    ctx.log(f"{ctx.name}: losses program {prog['losses']} reference "
            f"{r['losses']}")
    return Outcome(end_to_end={"setup_s": setup_s,
                               ctx.spec["step_metric"]: secs / steps * 1e3},
                   attempted=steps, failed=failed, gaps=gaps,
                   memory_peak_bytes=peak, counters=counters,
                   reduction=tracer.reduction)
