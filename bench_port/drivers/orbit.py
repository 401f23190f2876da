"""The orbit driver: a user watching a moving camera, one client in a
closed loop, a new pose every frame.

Set-up makes the configuration's grid on the device, hands a copy to the
program as a dense field, and builds ``render/posed.py::PosedRenderer``
over the cell's poses (its pins probed over all of them; graph mode on
the card), then renders a few poses, the first of which records the
graph. The window renders the poses in turn, from a start drawn from the
seed, each frame from the pose handed to ``PosedRenderer.render`` to its
planes ready (a synchronize), until its time is up.

Reported: ``frames_per_s`` (frames over the window's host time),
``frame_ms_p95`` (the 95th percentile of every frame's time) and
``setup_s``. A sample of the window's frames, drawn from the seed, is
kept; after the window the reference renders their poses and the numbers
of :func:`bench_port.lib.checks.frame_gaps` are compared.
"""

from __future__ import annotations

import statistics

from bench_port.lib import checks
from bench_port.lib import scene as S
from bench_port.lib.harness import Outcome
from bench_port.lib.trace import Tracer
from bench_port.reference import dense_grid as ref

WARM_FRAMES = 4
MAX_FRAMES = 1 << 17


def kept_frames(seed: int, every: int) -> set:
    """The window's frames the check keeps: about one in ``every``, drawn
    from the seed."""
    torch = ref.torch
    r = ref.jitter(seed, torch.arange(MAX_FRAMES), torch.tensor(1 << 20))
    return set(torch.nonzero(r * every < 1.0).reshape(-1).tolist())


def run(ctx) -> Outcome:
    torch, dev, tr = ctx.torch, ctx.device, ctx.spec["traffic"]
    import dvren_tpu_torch as P
    from dvren_tpu_torch.render.posed import PosedRenderer

    ctx.mark("program imported")
    sc = S.scene(ctx.config, tr)
    poses = S.poses(tr)
    sigma, color = S.grid(ctx.config, dev)
    field = P.DenseGridField(sigma.clone(), color.clone(),
                             bbox_min=sc.bbox_min, bbox_max=sc.bbox_max)
    plans = [S.plan(P, sc, c) for c in poses]
    S.settle(torch, dev)
    renderer = PosedRenderer(plans[0], field, probe_plans=plans)
    ctx.mark("renderer built and probed")
    start = ctx.seed % len(plans)
    for i in range(WARM_FRAMES):
        renderer.render(plans[(start + i) % len(plans)], field)
    S.sync(torch, dev)
    ctx.log(f"{ctx.name}: pins nc {renderer.nc_pin} nb {renderer.nb_pin} "
            f"ez {renderer.ez_pin}; graphs {renderer.cache_size()}")

    sample = kept_frames(ctx.seed, int(tr["check_every"]))
    cap = int(tr["check_frames"])
    tracer = Tracer(torch, dev, ctx.trace)
    times, kept = [], []
    traced = not ctx.trace
    S.steady()
    t0 = S.clock()
    f = 0

    def frame(i):
        j = (start + WARM_FRAMES + i) % len(plans)
        a = S.clock()
        planes = renderer.render(plans[j], field)
        S.sync(torch, dev)
        times.append((S.clock() - a) * 1e3)
        if len(kept) < cap and i in sample:
            kept.append((j, planes.image, planes.opacity))

    while True:
        if not traced and S.clock() - t0 >= ctx.seconds / 2:
            n = int(tr["traced_frames"])
            with tracer.stretch(n):
                for _ in range(n):
                    frame(f)
                    f += 1
            traced = True
            continue
        frame(f)
        f += 1
        if traced and f >= 2 and S.clock() - t0 >= ctx.seconds:
            break
    secs = S.clock() - t0
    setup_s = t0 - ctx.t0
    peak = S.peak(torch, dev)
    counters = {"capture_ms": (renderer.captured.capture_ms
                               if renderer.captured is not None else None)}
    q = statistics.quantiles(times, n=100)
    ctx.log(f"{ctx.name}: {f} frames in {secs:.3f} s, {len(kept)} kept; "
            f"setup {setup_s:.3f} s; frame ms p50 {q[49]:.3f} p90 "
            f"{q[89]:.3f} p95 {q[94]:.3f} p99 {q[98]:.3f} max "
            f"{max(times):.3f}")
    del renderer, field
    S.free(torch, dev)

    frames, refs = [], []
    for j, img, op in kept:
        frames.append((img, op))
        refs.append(ref.render_view(sigma, color, sc, poses[j]))
    gaps = checks.frame_gaps(frames, refs)
    ctx.log(f"{ctx.name}: widest RGB gap {checks.widest_gap(frames, refs):.3g}")
    failed = sum(1 for img, op in frames
                 if not (torch.isfinite(img).all() and torch.isfinite(op).all()))
    return Outcome(end_to_end={
        "setup_s": setup_s, "frames_per_s": f / secs,
        "frame_ms_p95": q[94]},
        attempted=f, failed=failed, gaps=gaps, memory_peak_bytes=peak,
        counters=counters, reduction=tracer.reduction)
