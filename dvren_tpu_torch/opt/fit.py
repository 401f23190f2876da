"""The training loops: losses, per-view plans, the dense-grid fit and the
hash-MLP fit.

Counterpart of ``dvren_tpu/opt/fit.py``. A step renders through autograd,
calls ``loss.backward()`` and steps an optimizer over the field's
parameters. :func:`fit_dense_grid` fits a dense grid's sigma and colour
to target views with ``torch.optim.Adam`` in one of three modes: "tiled",
one merged multi-view tile schedule (:func:`_scheduled_views`: K1 and K2
once per merged group per step); "windowed", one merged multi-view
windowed schedule (K9f and K9b once per stack group per step); "plain",
the dense lattice of each view through ``pipeline.render`` (K9f / K9b
once per view). :func:`fit_hash_mlp` fits a hash-MLP field through K7f /
K7b.

JAX compiles a step into one executable (``jax.jit``) and k steps into
one more (``lax.scan``). Here, on a CUDA field, a step is recorded once
as a CUDA graph and replayed (:class:`_GraphedStep`,
``render/graph.py::capture_step``): its kernels run again with no Python
between them. A block of k steps replays that one graph k times and
copies each loss into a (k,) device tensor, so one recording serves every
block length. The optimizer must keep its step count on the device
(``Adam(..., capturable=True)``, which the fits build on a CUDA field);
one that does not raises ``DvrenError``. On a CPU field the same step
runs eagerly. The fits copy the losses to the host every ``sync_every``
steps and after the last, so a fit syncs where JAX's blocks end.
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field as dc_field, replace
from typing import Callable, Sequence

import numpy as np
import torch

from dvren_tpu_torch.core.plan import CameraConfig, InterpMode, OobPolicy, Plan
from dvren_tpu_torch.render import graph
from dvren_tpu_torch.utils import trace


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
    #                                (the fit.schedule span)
    first_step_s: float = 0.0      # the first step, kernel build and
    #                                the step graph's capture included
    steady_step_ms: float = 0.0    # mean of the remaining steps
    reached_target: bool = False
    mode: str = ""                 # the mode the fit ran (auto may
    #                                demote "tiled" to "windowed")
    recorded_launches: dict = dc_field(default_factory=dict)
    #                              kernel launches recorded into the step's
    #                              CUDA graph, by kernel name (empty on CPU)
    capture_ms: float = 0.0        # the step graph's warm-up and recording


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
    each loss as a device tensor, which the next step may overwrite: a
    graph's buffer; it is cloned at once) unless the target PSNR is reached at a
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
        pending.append(step().clone())
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
    them. ``mode="tiled"``: view 0 through the cascade
    (:func:`tiled.build_tiled_schedule_auto`) with uniform shapes, the
    other views at view 0's tile_px and cell_scale, every view rebuilt at
    the global (nc, nb) maxima when their shapes differ (so the merge is
    one group), the host builds in a thread pool, then one merge and one
    upload. ``mode="windowed"``: one windowed schedule over every view's
    rays (:func:`windowed.build_stack_schedule`), rendered by
    :func:`windowed.render_windowed_stack`. Traced as the
    ``fit.schedule`` span (``utils/trace.py``), the windowed build inside
    it as ``schedule.windowed``."""
    with trace.span("fit.schedule"):
        return _views(plan, cameras, field, mode)


def _views(plan: Plan, cameras: Sequence[CameraConfig], field, mode: str):
    """:func:`_scheduled_views`'s work, in no span of its own: the fits
    time it inside theirs."""
    from dvren_tpu_torch.render.pipeline import plan_jitter_table
    from dvren_tpu_torch.render.tiled import (build_tiled_schedule,
                                              build_tiled_schedule_auto,
                                              merge_view_schedules,
                                              render_tiled_stack)
    from dvren_tpu_torch.render.windowed import (build_stack_schedule,
                                                 render_windowed_stack)

    plans = view_plans(plan, cameras)
    jitter = plan_jitter_table(plan)
    if mode == "windowed":
        with trace.span("schedule.windowed"):
            stack = build_stack_schedule(plans, field.bbox_min,
                                         field.bbox_max, jitter=jitter,
                                         device=field.device)
        return plans, stack, functools.partial(render_windowed_stack, plan)
    if mode != "tiled":
        raise ValueError(f"unknown scheduled mode: {mode}")
    s0, _ = build_tiled_schedule_auto(plans[0], field, jitter=jitter,
                                      quantize="uniform")

    parent = trace.current()

    def build_view(p, shape=None):
        with trace.under(parent):       # a pool thread's spans nest here
            return build_tiled_schedule(
                p, field, jitter=jitter, tile_px=s0.tile_px,
                quantize="uniform", cell_scale=s0.cell_scale,
                uniform_shape=shape)

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
    merged = merge_view_schedules(per_view, plans=plans)
    with trace.span("schedule.upload"):
        merged = merged.to(field.device)

    def render_stack(f, scheds):
        return render_tiled_stack(plan, f, scheds)

    return plans, merged, render_stack


def _field_device(f, *_):
    """Where a fit's step ``step(f, ...)`` records: the field's CUDA
    device, else None (eager)."""
    return f.device if graph.available(f.device) else None


def _field_params(f, *_):
    return f.parameters()


def _run_body(body: Callable, inputs: tuple, held: tuple):
    """``body(*inputs)``; ``held`` rides along, so that a recording of it
    keeps what the body reads alive."""
    return body(*inputs)


def _inputs_key(params, inputs) -> tuple:
    """What a recorded step reads: the parameters and every tensor input
    by :func:`graph.tensor_key`, every other input (a field, a list of
    tile shards, None) by its identity, which the recording holds."""
    return graph.tensor_key(*params) + tuple(
        graph.tensor_key(x) if isinstance(x, torch.Tensor) else ("id", id(x))
        for x in inputs)


class _GraphedStep:
    """A training step ``body(*inputs) -> loss`` that, where it has a
    device to record on, is recorded once as a CUDA graph
    (:func:`graph.capture_step`) and then replayed: the port's
    ``jax.jit`` of the step. The recording is keyed on the parameters and
    the inputs (:func:`_inputs_key`): a new field object, targets tensor
    or shards object records anew, an in-place optimizer step replays.
    ``step(*inputs)`` returns the step's loss as a tensor of its own;
    without a device it runs ``body``. ``graph`` is the current recording
    (None before the first step on the card, and always when the step
    runs eagerly).

    ``device(*inputs)`` is where the step records, or None to run it
    eagerly, and ``params(*inputs)`` the parameters the recording restores
    after its warm-up; by default the first input is the field (the fits'
    ``step(f, targets)``), recorded on a CUDA device. ``hold(*inputs)``
    names what the body reads besides its inputs and closure (a rank's
    schedule from a cache): the recording keeps it alive and is keyed on
    it too."""

    def __init__(self, body: Callable, optimizer,
                 device: Callable = _field_device,
                 params: Callable = _field_params,
                 hold: Callable = lambda *_: ()):
        self.body = body
        self.optimizer = optimizer
        self.graph = None
        self._device = device
        self._params = params
        self._hold = hold
        self._key = None

    def loss(self, *inputs) -> torch.Tensor:
        """Run one step; its loss. On the card that is the graph's output
        buffer, which the next replay overwrites."""
        dev = self._device(*inputs)
        if dev is None:
            with trace.clock("fit.step", getattr(inputs[0], "device", None)):
                return self.body(*inputs)
        params = list(self._params(*inputs))
        held = tuple(self._hold(*inputs))
        key = _inputs_key(params, inputs + held)
        if key != self._key:
            self.graph = self._key = None   # freed before the next capture
            # the recorded function holds the body, the inputs and what
            # they read, not self, so the graph dies with the step
            self.graph = graph.capture_step(
                functools.partial(_run_body, self.body, inputs, held), dev,
                params, self.optimizer).owned_by("fit.step")
            self._key = key
        return self.graph.replay()

    def __call__(self, *inputs) -> torch.Tensor:
        out = self.loss(*inputs)
        return out.clone() if self.graph is not None else out


def _step_body(render: Callable, optimizer, sigma_min: float | None):
    """The eager training step the graph records: ``body(f, targets) ->
    loss`` renders ``render(f)`` through autograd, steps ``optimizer``
    and projects the field (:func:`_project`) unless ``sigma_min`` is
    None. Its stages (``utils/trace.py``): the render's, then ``loss``,
    ``backward`` (the loss's and the render's adjoints up to the render's
    first backward mark), ``optimizer`` (the step and the projection)."""

    def body(f, targets):
        optimizer.zero_grad(set_to_none=True)
        images = render(f)
        trace.stage("loss")
        loss = mse(images, targets)
        trace.stage("backward")
        loss.backward()
        trace.stage("optimizer")
        optimizer.step()
        if sigma_min is not None:
            _project(f, sigma_min)
        return loss.detach()

    return body


def make_train_step_scheduled(plan: Plan, cameras: Sequence[CameraConfig],
                              field, optimizer, mode: str = "tiled",
                              sigma_min: float = 0.0, views=None):
    """One training step over the merged multi-view schedule, built once
    and replayed every step: ``step(field, targets) -> loss`` renders the
    stack through autograd, steps ``optimizer`` (over ``field``'s
    parameters) and projects the field (:func:`_project`); on a CUDA
    field it is a recorded graph, replayed (:class:`_GraphedStep`).
    ``views``: a prebuilt :func:`_scheduled_views` result. Schedules
    depend on the field's bbox and resolution only, so they stay valid
    across parameter updates."""
    _, scheds, render_stack = views or _scheduled_views(
        plan, cameras, field, mode)
    return _GraphedStep(_step_body(lambda f: render_stack(f, scheds),
                                   optimizer, sigma_min), optimizer)


def make_train_block_scheduled(plan: Plan, cameras: Sequence[CameraConfig],
                               field, optimizer, k: int,
                               mode: str = "tiled", sigma_min: float = 0.0,
                               views=None):
    """``k`` optimizer steps of :func:`make_train_step_scheduled` as one
    block, with JAX's signature: ``block(f, targets) -> (k,)`` per-step
    losses in one device tensor. On a CUDA field the step's one graph is
    replayed k times, each loss copied into the (k,) tensor before the
    next replay, with no host sync inside the block (JAX's ``lax.scan``);
    on a CPU field the steps run eagerly. ``block.step`` is the step."""
    step = make_train_step_scheduled(plan, cameras, field, optimizer,
                                     mode=mode, sigma_min=sigma_min,
                                     views=views)

    def block(f, targets):
        if not graph.available(f.device):
            return torch.stack([step.body(f, targets)
                                for _ in range(int(k))])
        losses = torch.empty(int(k), dtype=torch.float32, device=f.device)
        for i in range(int(k)):
            losses[i].copy_(step.loss(f, targets))
        return losses

    block.step = step
    return block


def _view_inputs(plan: Plan, cameras: Sequence[CameraConfig], device,
                 table: bool = True):
    """Each view's c2w (3, 4), the plan's jitter table (None for FIXED
    sampling, or with ``table=False``: the lattice then hashes its jitter
    on the device) and the plan's k (3, 3) and ortho_scale () on
    ``device``, uploaded once: a recorded step reads them and uploads
    nothing."""
    from dvren_tpu_torch.ops.raygen import camera_arrays
    from dvren_tpu_torch.render.pipeline import plan_jitter_table

    c2ws = [torch.tensor(c.c2w, dtype=torch.float32,
                         device=device).reshape(3, 4) for c in cameras]
    jitter = plan_jitter_table(plan) if table else None
    if jitter is not None:
        jitter = torch.from_numpy(jitter.copy()).to(device)
    k, _, ortho_scale = camera_arrays(plan, device)
    return c2ws, jitter, k, ortho_scale


def _render_stack(plan: Plan, field, c2ws, jitter, k,
                  ortho_scale) -> torch.Tensor:
    from dvren_tpu_torch.render.pipeline import render

    return torch.stack([render(plan, field, k=k, c2w=c2w,
                               ortho_scale=ortho_scale, jitter=jitter)
                        .planes.image for c2w in c2ws])


def render_views(plan: Plan, field, cameras: Sequence[CameraConfig]):
    """(V, H, W, 3) images of ``field`` from each camera's pose: the
    plan's whole lattice through ``pipeline.render`` per view (K9f on
    CUDA tensors), differentiable. JAX vmaps one render over the stacked
    poses; here the views run in turn, with the same values."""
    return _render_stack(plan, field, *_view_inputs(plan, cameras,
                                                    field.device))


def make_train_step(plan: Plan, cameras: Sequence[CameraConfig], field,
                    optimizer, sigma_min: float | None = 0.0):
    """The plain training step: each view's whole lattice through
    :func:`dvren_tpu_torch.render.pipeline.render` at its ``c2w`` (the
    port's per-ray integrator), the MSE over the (V, H, W, 3) stack,
    ``optimizer``'s step, then the projection unless ``sigma_min`` is
    None (``dvren_tpu``'s ``make_train_step``); on a CUDA field a
    recorded graph, replayed (:class:`_GraphedStep`)."""
    inputs = _view_inputs(plan, cameras, field.device)
    return _GraphedStep(_step_body(
        lambda f: _render_stack(plan, f, *inputs), optimizer, sigma_min),
        optimizer)


def _adam(field, learning_rate: float):
    """optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8) over the field's
    parameters; on a CUDA field with its step count on the device
    (``capturable=True``), so that a CUDA graph records its step. (This
    torch refuses ``capturable=True`` on the CPU.)"""
    return torch.optim.Adam(field.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            capturable=field.device.type == "cuda")


def _fit(step: _GraphedStep, trained, targets, snapshot: Callable,
         config: FitConfig, result: FitResult,
         checkpoint_cb: Callable | None) -> FitResult:
    """Run ``step`` as :func:`_run_steps` says and record its graph's
    launches and capture time in ``result``."""
    _run_steps(lambda: step.loss(trained, targets), snapshot, config,
               trained.device, result, checkpoint_cb)
    if step.graph is not None:
        result.recorded_launches = dict(step.graph.launches)
        result.capture_ms = step.graph.capture_ms
    result.field = trained
    return result


def fit_dense_grid(plan: Plan, field, cameras: Sequence[CameraConfig],
                   targets, config: FitConfig | None = None,
                   checkpoint_cb: Callable | None = None,
                   mode: str | None = None) -> FitResult:
    """Fit a DenseGridField's sigma and colour to target views (V, H, W, 3)
    with Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8; capturable
    on a CUDA field, whose step is a recorded graph, replayed).

    ``mode``: None (auto, as the JAX package picks: "tiled" for a
    trilinear OOB_ZERO grid, demoted to "windowed" when the merged
    schedule's table slots, weighted by row width, outnumber the views'
    sample lattice; "windowed" for another OOB_ZERO grid; "plain"
    otherwise), or "tiled", "windowed" or "plain". ``result.mode`` is the
    mode that ran. The steps, sync points and checkpoints run as
    :func:`_run_steps` says; ``first_step_s`` includes the step graph's
    capture, as JAX's includes its compile. The input field is left as it
    is; the fitted one is ``result.field``."""
    config = config or FitConfig()
    auto = mode is None
    if auto:
        mode = scheduled_mode_for(field) or "plain"
    dev = field.device
    with trace.timed("fit.schedule") as build:
        views = (_views(plan, cameras, field, mode)
                 if mode in ("tiled", "windowed") else None)
        if auto and mode == "tiled":
            # the JAX fit's table-economy check: slot traffic in
            # cell-stencil equivalents (a supercell slot carries 108
            # values, a cell slot 32) against the views' full sample
            # lattice
            sched = views[1].sched
            wgt = 108 / 32 if sched.cell_scale == 2 else 1.0
            slots = sum(g.n_tiles * g.banks * 128
                        for g in sched.groups) * wgt
            lattice = sum(int(p.ray_count) * int(p.sampling.max_steps)
                          for p in views[0])
            if slots > lattice:
                mode = "windowed"
                views = _views(plan, cameras, field, mode)
        trained = field.with_params(field.sigma.detach().clone(),
                                    field.color.detach().clone())
        optimizer = _adam(trained, config.learning_rate)
        if mode == "plain":
            step = make_train_step(plan, cameras, trained, optimizer,
                                   sigma_min=config.sigma_min)
        else:
            step = make_train_step_scheduled(plan, cameras, trained,
                                             optimizer, mode=mode,
                                             sigma_min=config.sigma_min,
                                             views=views)
        if not isinstance(targets, torch.Tensor):
            targets = np.array(targets, np.float32)     # a writable copy
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        result = FitResult(field=field, mode=mode)
    result.schedule_build_s = build.seconds
    return _fit(step, trained, targets,
                lambda: trained.with_params(trained.sigma.detach().clone(),
                                            trained.color.detach().clone()),
                config, result, checkpoint_cb)


def _hash_train_step(plan: Plan, stack, optimizer) -> _GraphedStep:
    """The hash-MLP training step over a view stack's schedule
    (``render_hash_tiled_stack``: K7f and K7b once each), as
    :class:`_GraphedStep`; no projection."""
    from dvren_tpu_torch.render.hash_tiled import render_hash_tiled_stack

    return _GraphedStep(_step_body(
        lambda f: render_hash_tiled_stack(plan, f, stack), optimizer, None),
        optimizer)


def fit_hash_mlp(plan: Plan, field, cameras: Sequence[CameraConfig],
                 targets, config: FitConfig | None = None,
                 checkpoint_cb: Callable | None = None) -> FitResult:
    """Fit a HashMLPField (hash table and both MLP heads) to target views
    (V, H, W, 3) with Adam through the fused hash kernels (capturable on
    a CUDA field, whose step is a recorded graph, replayed).

    The schedule is pure frame layout, built once and uploaded once. The
    steps, sync points and checkpoints run as :func:`_run_steps` says. The
    input field is left as it is; the fitted one is ``result.field``."""
    from dvren_tpu_torch.render.hash_tiled import build_hash_schedule_stack

    config = config or FitConfig()
    dev = field.device
    with trace.timed("fit.schedule") as build:
        stack = build_hash_schedule_stack(view_plans(plan, cameras),
                                          device=dev)
        targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
        result = FitResult(field=field, mode="hash_tiled")
    result.schedule_build_s = build.seconds

    trained = field.with_params(
        {k: v.detach().clone() for k, v in field.params.items()})
    step = _hash_train_step(plan, stack,
                            _adam(trained, config.learning_rate))
    return _fit(step, trained, targets, lambda: trained.with_params(
        {k: v.detach().clone() for k, v in trained.params.items()}),
        config, result, checkpoint_cb)
