"""The training loops: losses, per-view plans, the dense-grid fit and the
hash-MLP fit.

Counterpart of ``dvren_tpu/opt/fit.py``. A step is plain PyTorch: render
through autograd of a fused tiled path, ``loss.backward()``, an optimizer
step on the field's parameters. :func:`fit_dense_grid` fits a dense
grid's sigma and colour to target views with ``torch.optim.Adam`` over
one merged multi-view schedule (:func:`_scheduled_views`: K1 and K2 once
per merged group per step); :func:`fit_hash_mlp` fits a hash-MLP field
through K7f / K7b. The JAX package's windowed and plain fit modes wait
for the windowed path and the lattice integrator (ROADMAP Queue 1 items
11 and 4). JAX runs ``sync_every`` steps in one ``lax.scan``; here the
steps run one by one and the losses are copied to the host every
``sync_every`` steps.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field as dc_field, replace
from typing import Callable, Sequence

import torch

from dvren_tpu_torch.core.plan import CameraConfig, InterpMode, OobPolicy, Plan

_TODO_WINDOWED = ("the windowed fit mode, which needs the windowed path "
                  "(ROADMAP Queue 1 item 11)")
_TODO_PLAIN = ("the plain fit mode, which needs the lattice integrator "
               "(ROADMAP Queue 1 item 4)")


@dataclass
class FitConfig:
    learning_rate: float = 5e-2
    steps: int = 500
    target_psnr: float | None = 35.0
    log_every: int = 50
    sigma_min: float = 0.0       # project sigma to >= sigma_min after each
    #                              step (and colour to [0, 1])
    sync_every: int = 1          # steps per host copy of the losses; the
    #                              per-step history stays complete and the
    #                              target-PSNR stop is checked per copy


@dataclass
class FitResult:
    field: object
    psnr_history: list[float] = dc_field(default_factory=list)
    loss_history: list[float] = dc_field(default_factory=list)
    steps_run: int = 0
    wall_clock_s: float = 0.0      # includes the schedule build
    schedule_build_s: float = 0.0  # host schedule build + merge + upload
    first_step_s: float = 0.0      # the first step, kernel build included
    steady_step_ms: float = 0.0    # mean of the remaining steps
    reached_target: bool = False
    mode: str = ""                 # the schedule mode the fit ran


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(loss: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp_min(loss, 1e-12))


def view_plans(plan: Plan, cameras: Sequence[CameraConfig]):
    """Per-view plans: the plan's camera with each view's pose."""
    return [plan.with_camera(replace(plan.camera, c2w=tuple(c.c2w)))
            for c in cameras]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_steps(step: Callable, snapshot: Callable, config: FitConfig,
               device, result: FitResult,
               checkpoint_cb: Callable | None) -> None:
    """Run exactly ``config.steps`` optimizer steps (``step()`` returns
    each loss as a device tensor) unless the target PSNR is reached at a
    sync point: every ``sync_every`` steps the losses are copied to the
    host, the histories grow by them and ``checkpoint_cb(snapshot(),
    steps, psnr)`` fires when a sync point passes a multiple of
    ``log_every`` (the JAX fit's cadence; ``snapshot()`` copies the
    field, as the JAX fit hands over immutable params). Fills ``result``'s
    step times: ``steady_step_ms`` is the mean of every step after the
    first, nonzero whenever more than one step ran; ``wall_clock_s`` adds
    the ``schedule_build_s`` already in it."""
    k = max(int(config.sync_every), 1)
    pending = []
    ckpts_fired = 0
    t0 = time.perf_counter()
    for i in range(int(config.steps)):
        pending.append(step())
        if i == 0:
            _sync(device)
            result.first_step_s = time.perf_counter() - t0
        if len(pending) < k and i + 1 < config.steps:
            continue
        losses = torch.stack(pending).cpu().tolist()
        pending = []
        ps = [float(psnr(torch.tensor(lf, dtype=torch.float32)))
              for lf in losses]
        result.loss_history.extend(losses)
        result.psnr_history.extend(ps)
        result.steps_run = i + 1
        if checkpoint_cb is not None:
            due = result.steps_run // max(config.log_every, 1)
            if due > ckpts_fired:
                ckpts_fired = due
                checkpoint_cb(snapshot(), result.steps_run, ps[-1])
        if config.target_psnr is not None and ps[-1] >= config.target_psnr:
            result.reached_target = True
            break
    _sync(device)
    steps_s = time.perf_counter() - t0
    result.wall_clock_s = result.schedule_build_s + steps_s
    if result.steps_run > 1:
        result.steady_step_ms = ((steps_s - result.first_step_s)
                                 / (result.steps_run - 1) * 1e3)


def _project(field, sigma_min: float) -> None:
    """Keep density physical (sigma >= sigma_min) and colour in [0, 1],
    in place after an optimizer step (``dvren_tpu``'s ``_project``)."""
    with torch.no_grad():
        field.sigma.clamp_min_(sigma_min)
        field.color.clamp_(0.0, 1.0)


def scheduled_mode_for(field) -> str | None:
    """The fastest schedule mode for a field: "tiled" for a dense
    trilinear OOB_ZERO grid, "windowed" for a dense OOB_ZERO grid with
    another interpolation, None when only the plain lattice path applies
    (``dvren_tpu``'s rule)."""
    if not all(hasattr(field, a)
               for a in ("bbox_min", "bbox_max", "with_params", "sigma")):
        return None
    if getattr(field, "oob", None) != OobPolicy.ZERO:
        return None
    sigma = field.sigma
    if sigma.dim() != 3 or min(int(v) for v in sigma.shape) < 2:
        return None
    if getattr(field, "interp", None) == InterpMode.LINEAR:
        return "tiled"
    return "windowed"


def _scheduled_views(plan: Plan, cameras: Sequence[CameraConfig], field,
                     mode: str):
    """(per-view plans, the merged schedule on the field's device,
    ``render_stack(f, merged) -> (V, H, W, 3)``), as ``dvren_tpu`` builds
    them for ``mode="tiled"``: view 0 through the cascade
    (:func:`tiled.build_tiled_schedule_auto`) with uniform shapes, the
    other views at view 0's tile_px and cell_scale, every view rebuilt at
    the global (nc, nb) maxima when their shapes differ (so the merge is
    one group), the host builds in a thread pool, then one merge and one
    upload. "windowed" raises ``NotImplementedError`` (item 11)."""
    from dvren_tpu_torch.render.pipeline import plan_jitter_table
    from dvren_tpu_torch.render.tiled import (build_tiled_schedule,
                                              build_tiled_schedule_auto,
                                              merge_view_schedules,
                                              render_tiled_stack)

    if mode == "windowed":
        raise NotImplementedError(_TODO_WINDOWED)
    if mode != "tiled":
        raise ValueError(f"unknown scheduled mode: {mode}")
    plans = view_plans(plan, cameras)
    jitter = plan_jitter_table(plan)
    s0, _ = build_tiled_schedule_auto(plans[0], field, jitter=jitter,
                                      quantize="uniform")

    def build_view(p, shape=None):
        return build_tiled_schedule(
            p, field, jitter=jitter, tile_px=s0.tile_px, quantize="uniform",
            cell_scale=s0.cell_scale, uniform_shape=shape)

    with ThreadPoolExecutor(min(8, max(len(plans) - 1, 1))) as ex:
        per_view = [s0] + list(ex.map(build_view, plans[1:]))
    shapes = {(g.n_chunks, g.banks) for s in per_view for g in s.groups}
    if len(shapes) > 1:
        top = (max(sh[0] for sh in shapes), max(sh[1] for sh in shapes))
        todo = [i for i, s in enumerate(per_view)
                if {(g.n_chunks, g.banks) for g in s.groups} != {top}]
        with ThreadPoolExecutor(min(8, max(len(todo), 1))) as ex:
            rebuilt = list(ex.map(lambda i: build_view(plans[i], top), todo))
        for i, s in zip(todo, rebuilt):
            per_view[i] = s
    merged = merge_view_schedules(per_view, plans=plans).to(field.device)

    def render_stack(f, scheds):
        return render_tiled_stack(plan, f, scheds)

    return plans, merged, render_stack


def make_train_step_scheduled(plan: Plan, cameras: Sequence[CameraConfig],
                              field, optimizer, mode: str = "tiled",
                              sigma_min: float = 0.0, views=None):
    """One training step over the merged multi-view schedule, built once
    and replayed every step: ``step(field, targets) -> loss`` renders the
    stack through autograd, steps ``optimizer`` (over ``field``'s
    parameters) and projects the field (:func:`_project`). ``views``: a
    prebuilt :func:`_scheduled_views` result. Schedules depend on the
    field's bbox and resolution only, so they stay valid across
    parameter updates."""
    _, scheds, render_stack = views or _scheduled_views(
        plan, cameras, field, mode)

    def step(f, targets):
        optimizer.zero_grad(set_to_none=True)
        loss = mse(render_stack(f, scheds), targets)
        loss.backward()
        optimizer.step()
        _project(f, sigma_min)
        return loss.detach()

    return step


def fit_dense_grid(plan: Plan, field, cameras: Sequence[CameraConfig],
                   targets, config: FitConfig | None = None,
                   checkpoint_cb: Callable | None = None,
                   mode: str | None = None) -> FitResult:
    """Fit a DenseGridField's sigma and colour to target views (V, H, W, 3)
    with Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8).

    ``mode``: None (auto: "tiled" for a trilinear OOB_ZERO grid, unless
    the merged schedule's table slots, weighted by row width, outnumber
    the views' sample lattice: then the JAX package takes the windowed
    replay) or "tiled". The windowed and plain modes, and an auto choice
    of either, raise ``NotImplementedError`` (items 11 and 4). The steps,
    sync points and checkpoints run as :func:`_run_steps` says. The input
    field is left as it is; the fitted one is ``result.field``."""
    config = config or FitConfig()
    auto = mode is None
    if auto:
        mode = scheduled_mode_for(field) or "plain"
    if mode == "plain":
        raise NotImplementedError(_TODO_PLAIN)
    dev = field.device
    t_build0 = time.perf_counter()
    views = _scheduled_views(plan, cameras, field, mode)
    if auto:
        # the JAX fit's table-economy check: slot traffic in cell-stencil
        # equivalents (a supercell slot carries 108 values, a cell slot
        # 32) against the views' full sample lattice
        sched = views[1].sched
        wgt = 108 / 32 if sched.cell_scale == 2 else 1.0
        slots = sum(g.n_tiles * g.banks * 128 for g in sched.groups) * wgt
        lattice = sum(int(p.ray_count) * int(p.sampling.max_steps)
                      for p in views[0])
        if slots > lattice:
            raise NotImplementedError(
                f"the auto mode chose {_TODO_WINDOWED}: {slots:.0f} weighted "
                f"table slots against a {lattice}-sample lattice")
    trained = field.with_params(field.sigma.detach().clone(),
                                field.color.detach().clone())
    optimizer = torch.optim.Adam(trained.parameters(),
                                 lr=config.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step_scheduled(plan, cameras, trained, optimizer,
                                     mode=mode, sigma_min=config.sigma_min,
                                     views=views)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    result = FitResult(field=field, mode=mode)
    result.schedule_build_s = time.perf_counter() - t_build0
    _run_steps(lambda: step(trained, targets),
               lambda: trained.with_params(trained.sigma.detach().clone(),
                                           trained.color.detach().clone()),
               config, dev, result, checkpoint_cb)
    result.field = trained
    return result


def fit_hash_mlp(plan: Plan, field, cameras: Sequence[CameraConfig],
                 targets, config: FitConfig | None = None,
                 checkpoint_cb: Callable | None = None) -> FitResult:
    """Fit a HashMLPField (hash table and both MLP heads) to target views
    (V, H, W, 3) with Adam through the fused hash kernels.

    The schedule is pure frame layout, built once and uploaded once. The
    steps, sync points and checkpoints run as :func:`_run_steps` says. The
    input field is left as it is; the fitted one is ``result.field``."""
    from dvren_tpu_torch.render.hash_tiled import (build_hash_schedule_stack,
                                                   render_hash_tiled_stack)

    config = config or FitConfig()
    dev = field.device
    t_build0 = time.perf_counter()
    stack = build_hash_schedule_stack(view_plans(plan, cameras), device=dev)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    result = FitResult(field=field, mode="hash_tiled")
    result.schedule_build_s = time.perf_counter() - t_build0

    trained = field.with_params(
        {k: v.detach().clone() for k, v in field.params.items()})
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
    optimizer = torch.optim.Adam(trained.parameters(),
                                 lr=config.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = mse(render_hash_tiled_stack(plan, trained, stack), targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    _run_steps(step, lambda: trained.with_params(
        {k: v.detach().clone() for k, v in trained.params.items()}),
        config, dev, result, checkpoint_cb)
    result.field = trained
    return result
