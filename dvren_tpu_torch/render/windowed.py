"""Window-clipped rendering: skip provably-zero samples outside the field
bbox.

Counterpart of ``dvren_tpu/render/windowed.py``. For an OOB_ZERO field
every lattice step outside the field's bbox contributes exactly zero
(sigma == 0, so weight 0; the depth cursor advances by the full dt
either way), so those steps can be skipped without changing any output.
The schedule is built on the host per (plan, camera, bbox):

1. regenerate the rays in numpy and slab-test them against the bbox;
2. per ray, its first and last live lattice steps inside the bbox (global
   step indices, so the base_t grid, jitter keying and dt truncation are
   the full lattice's);
3. sort the rays by window length into blocks of ``block`` rays; each
   block's step budget is the smallest multiple of 32 covering its rays.

Each group renders through the pipeline's stages (raygen by ray id,
sampling from the group's first step, field evaluation, the port's
per-ray integrator, K9f / K9b on the card) and the rays' results are
composed by pixel id. Besides whole frames, the tiled renderer sends the
rays whose tiles overflow its slot tables here (its windowed fallback),
and the multi-view fit merges every view's rays into one schedule
(:func:`build_stack_schedule`, :func:`render_windowed_stack`).

When the residuals of the whole frame would exceed 4 GiB (about 200
bytes per windowed sample), each group is recomputed in the backward
(``torch.utils.checkpoint``, where JAX remats).

Traced (``utils/trace.py``), a render marks each group's stages ``eval``
(the rays, the samples and the row gathers), ``stencil`` (the packed
stencil, in
:meth:`~dvren_tpu_torch.fields.dense_grid.DenseGridField.packed_eval_planes`)
and ``k9f``, then ``compose``; its backward marks each group's ``k9b``,
``eval_grad`` (the gathers' adjoint into the stencil rows) and
``stencil_grad``. A recomputed group marks its forward's stages again
inside the backward, under the same names, and a step's reading of a
stage sums every group's. The counters ``windowed.renders``,
``windowed.groups``, ``windowed.samples`` (the schedule's windowed
samples) and ``windowed.remat_groups`` (groups recomputed in a backward)
grow with each render, so each over ``windowed.renders`` is a step's.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dvren_tpu_torch.core.context import resolve_device
from dvren_tpu_torch.core.plan import CameraModel, OobPolicy, Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops.compose import ImagePlanes, compose
from dvren_tpu_torch.ops.raygen import Rays, generate_rays
from dvren_tpu_torch.ops.sampling import generate_samples
from dvren_tpu_torch.render.pipeline import eval_fields, integrate_heads
from dvren_tpu_torch.utils import trace

_STEP_QUANTUM = 32                 # budgets are multiples of this
_REMAT_RESIDUAL_BUDGET = 4 << 30   # bytes of residuals kept without remat
_RESIDUAL_BYTES_PER_SAMPLE = 200


def _host_rays(plan: Plan):
    """Numpy ray generator, float32: (origins (N, 3), directions (N, 3))."""
    roi = plan.roi
    n = plan.ray_count
    idx = np.arange(n, dtype=np.int64)
    px = (roi.x + idx % roi.width).astype(np.float32)
    py = (roi.y + idx // roi.width).astype(np.float32)
    k = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
    c2w = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
    rot, trans = c2w[:, :3], c2w[:, 3]
    if plan.camera.model == CameraModel.PINHOLE:
        a = ((px + 0.5) - k[0, 2]) / k[0, 0]
        b = ((py + 0.5) - k[1, 2]) / k[1, 1]
        d = (np.stack([a, b, np.ones_like(a)], -1) @ rot.T).astype(np.float32)
        o = np.broadcast_to(trans, (n, 3)).astype(np.float32)
    else:
        scale = np.float32(plan.camera.ortho_scale)
        u = (px - k[0, 2]) / k[0, 0] * scale
        v = (py - k[1, 2]) / k[1, 1] * scale
        d = np.broadcast_to(rot[:, 2], (n, 3)).astype(np.float32)
        o = (trans + np.stack([u, v], -1) @ rot[:, :2].T).astype(np.float32)
    # Normalise as the JAX package's device ray generator does:
    # inv = 1/sqrt(max(len_sq, FLT_MIN)), then multiply (dividing by the
    # sqrt rounds differently by 1 ulp).
    len_sq = np.maximum((d * d).sum(-1, keepdims=True).astype(np.float32),
                        np.float32(1.1754943508222875e-38))
    inv = np.float32(1.0) / np.sqrt(len_sq)
    return o, (d * inv).astype(np.float32)


def _windows(plan: Plan, bbox_min, bbox_max):
    """Per-ray (k_enter, k_count) of live lattice steps inside the bbox.

    Conservative by one step on each side, so float rounding between the
    host f64 slab test and the f32 march can never clip a contributing
    sample."""
    o, d = _host_rays(plan)
    o = o.astype(np.float64)
    d = d.astype(np.float64)
    lo = np.asarray(bbox_min, np.float64)
    hi = np.asarray(bbox_max, np.float64)

    # d == 0 axes are handled explicitly: a ray on a bbox face with d == 0
    # is inside that slab for all t.
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = np.where(d == 0, -np.inf, (lo - o) / d)
        t1 = np.where(d == 0, np.inf, (hi - o) / d)
    near = np.minimum(t0, t1).max(axis=1)
    far = np.maximum(t0, t1).min(axis=1)
    # A ray parallel to an axis is outside its slab by the float32
    # local-coordinate test the march uses, not by an f64 comparison: an
    # origin 1 ulp past the face in f64 can round to local == 1.0 in f32.
    o32 = o.astype(np.float32)
    ext = (hi - lo).astype(np.float64)
    inv32 = np.where(ext != 0.0, 1.0 / np.where(ext == 0.0, 1.0, ext),
                     0.0).astype(np.float32)
    local32 = ((o32 - lo.astype(np.float32)) * inv32).astype(np.float32)
    slab_out32 = (local32 < 0.0) | (local32 > 1.0)
    parallel_out = ((d == 0) & slab_out32).any(axis=1)
    hit = (far >= near) & (far >= 0) & ~parallel_out

    dt = plan.sampling.dt
    t_near, t_far = plan.t_near, plan.t_far
    k_max = plan.sampling.max_steps
    enter_t = np.maximum(near, t_near)
    exit_t = np.minimum(far, t_far)
    hit &= exit_t > enter_t
    # sanitise before the int casts below: missed rays may carry +/-inf
    enter_t = np.where(hit, enter_t, t_near)
    exit_t = np.where(hit, exit_t, t_near)

    k_enter = np.floor((enter_t - t_near) / dt).astype(np.int64) - 1
    k_exit = np.ceil((exit_t - t_near) / dt).astype(np.int64) + 1
    k_enter = np.clip(k_enter, 0, k_max)
    k_exit = np.clip(k_exit, 0, k_max)
    # also bounded by the t_far truncation of the global lattice
    k_live_far = int(math.ceil((t_far - t_near) / dt - 1e-12))
    k_exit = np.minimum(k_exit, min(k_max, k_live_far))

    k_enter = np.where(hit, k_enter, 0).astype(np.int32)
    k_count = np.where(hit, np.maximum(k_exit - k_enter, 0),
                       0).astype(np.int32)
    return k_enter, k_count


def roi_hitmask(plan: Plan, device=None) -> torch.Tensor:
    """(H, W) int32 hitmask: 1 on every ROI pixel (each received a
    generated ray, img_cpu.cpp:169-176), 0 elsewhere. ``device`` defaults
    as :class:`~dvren_tpu_torch.Context`'s does: CUDA unless the caller
    names ``"cpu"``."""
    roi = plan.roi
    mask = torch.zeros((plan.height, plan.width), dtype=torch.int32,
                       device=resolve_device(device))
    mask[roi.y:roi.y + roi.height, roi.x:roi.x + roi.width] = 1
    return mask


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


class _Groups:
    """``to`` and ``device`` of a schedule whose ``groups`` are tuples of
    (budget, ids, ...) arrays."""

    def to(self, device):
        """The schedule with every array as a tensor on ``device``."""
        return dataclasses.replace(self, groups=tuple(
            tuple(_to_device(x, device) for x in grp)
            for grp in self.groups))

    @property
    def device(self):
        """The device of the arrays, or None while they are numpy (or
        there are none)."""
        for grp in self.groups:
            if isinstance(grp[1], torch.Tensor):
                return grp[1].device
        return None


@dataclass(frozen=True)
class WindowedSchedule(_Groups):
    """Per group (step budget, ray ids (M,) int32, first step (M,) int32,
    jitter rows (M, budget) float32 or None), as numpy arrays or, after
    :meth:`to`, tensors. Pad entries carry ids from ``total_rays`` up:
    degenerate rays whose pixels the compose drops."""

    groups: tuple
    total_rays: int
    skipped_rays: int
    full_lattice_samples: int
    windowed_samples: int


def _placed(sched, device):
    """``sched`` moved as ``device`` says: False keeps numpy, anything
    else goes through :func:`resolve_device`."""
    if device is False:
        return sched
    return sched.to(resolve_device(device))


def _jitter_rows(jitter: np.ndarray, rows: np.ndarray, ke: np.ndarray,
                 budget: int) -> np.ndarray:
    cols = np.minimum(ke[:, None] + np.arange(budget)[None, :],
                      jitter.shape[1] - 1)
    return jitter[np.minimum(rows, jitter.shape[0] - 1)[:, None], cols]


def build_schedule(plan: Plan, bbox_min, bbox_max, block: int = 32768,
                   jitter: np.ndarray | None = None,
                   ray_subset: np.ndarray | None = None,
                   device=None) -> WindowedSchedule:
    """The windowed schedule of ``plan`` for a field bbox.

    ``jitter``: the (N, K) host table of a stratified plan; each group's
    rows are gathered from it here. ``ray_subset``: restrict the schedule
    to these global ray ids (the tiled renderer's fallback). ``device``:
    where the arrays go (CUDA by default, as
    :func:`~dvren_tpu_torch.core.context.resolve_device` has it); False
    keeps them numpy (a caller that embeds the schedule moves it with
    its own)."""
    k_enter, k_count = _windows(plan, bbox_min, bbox_max)
    n = plan.ray_count
    if ray_subset is not None:
        subset_mask = np.zeros(n, bool)
        subset_mask[np.asarray(ray_subset, np.int64)] = True
        k_count = np.where(subset_mask, k_count, 0)
    live = np.nonzero(k_count > 0)[0]
    order = live[np.argsort(-k_count[live], kind="stable")]
    if jitter is not None:
        jitter = np.asarray(jitter, np.float32)

    groups = []
    windowed = 0
    pad_base = n  # distinct out-of-range ids keep the compose's ids unique
    for start in range(0, order.size, block):
        ids = order[start:start + block]
        budget = int(k_count[ids].max())
        budget = min(-(-budget // _STEP_QUANTUM) * _STEP_QUANTUM,
                     plan.sampling.max_steps)
        group_size = min(block, -(-ids.size // 256) * 256)
        if ids.size < group_size:
            pad = np.arange(pad_base, pad_base + group_size - ids.size)
            pad_base += group_size - ids.size
            ids = np.concatenate([ids, pad])
        ke = np.where(ids < n, k_enter[np.minimum(ids, n - 1)], 0)
        jit_rows = (None if jitter is None
                    else _jitter_rows(jitter, ids, ke, budget))
        groups.append((budget, ids.astype(np.int32), ke.astype(np.int32),
                       jit_rows))
        windowed += ids.size * budget
    sched = WindowedSchedule(
        groups=tuple(groups), total_rays=n,
        skipped_rays=n - int(live.size),
        full_lattice_samples=n * plan.sampling.max_steps,
        windowed_samples=windowed)
    return _placed(sched, device)


def _check_window_field(field):
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "window clipping requires an OOB_ZERO field (outside samples "
          "must be exactly zero)")


def _remat(windowed_samples: int, remat) -> bool:
    if remat is None:
        return (windowed_samples * _RESIDUAL_BYTES_PER_SAMPLE
                > _REMAT_RESIDUAL_BUDGET)
    return bool(remat)


def _window_parts(plan: Plan, budget: int, field, rays: Rays, table_ids,
                  k_enter, block_jitter, use_kernel: bool):
    """(pixel ids, radiance (M, 3), T, opacity, depth) of a group's
    ``rays``: their windows of ``budget`` steps from ``k_enter``, the
    field, the per-ray integrator. Without ``block_jitter`` the jitter is
    hashed on the device, keyed on ``table_ids``."""
    ray_offset = 0
    if block_jitter is None:
        ray_offset = table_ids.to(torch.int64) - torch.arange(
            table_ids.shape[0], dtype=torch.int64, device=table_ids.device)
    lattice = generate_samples(plan, rays, ray_index_offset=ray_offset,
                               jitter=block_jitter, step_offset=k_enter,
                               num_steps=budget)
    sigma, color = eval_fields(field, lattice)
    sigma, *color = trace.stage_on_backward("eval_grad", sigma, *color)
    trace.stage("k9f")
    t_origin = plan.t_near + k_enter.to(torch.float32) * plan.sampling.dt
    intl = integrate_heads(sigma, tuple(color), lattice, plan.t_near,
                           plan.t_far, t_origin=t_origin,
                           use_kernel=use_kernel)
    return (rays.pixel_ids, intl.radiance, intl.transmittance, intl.opacity,
            intl.depth)


def _group_outputs(plan: Plan, budget: int, field, ids, k_enter,
                   block_jitter, k=None, c2w=None, ortho_scale=None,
                   use_kernel: bool = True):
    """:func:`_window_parts` of one group's rays, generated by id (through
    the camera tensors when given)."""
    trace.stage("eval")
    rays = generate_rays(plan, ids=ids, k=k, c2w=c2w,
                         ortho_scale=ortho_scale)
    return _window_parts(plan, budget, field, rays, ids, k_enter,
                         block_jitter, use_kernel)


def _recounted(fn):
    """``fn``, counting each call after its first (a recompute in the
    backward) in ``windowed.remat_groups``."""
    calls = []

    def run(*args):
        if calls:
            trace.count("windowed.remat_groups")
        calls.append(None)
        return fn(*args)

    return run


def _run_groups(fn, args_per_group, remat: bool, samples: int) -> list:
    """``fn(*args)`` per group, each recomputed in the backward when
    ``remat`` (and autograd records); ``samples``, the schedule's
    windowed samples, for the counters."""
    trace.count("windowed.renders")
    trace.count("windowed.groups", len(args_per_group))
    trace.count("windowed.samples", samples)
    if remat and torch.is_grad_enabled():
        # no random draws to replay (the jitter is a table), and a CUDA
        # graph cannot record the RNG state's save
        return [checkpoint(_recounted(fn), *a, use_reentrant=False,
                           preserve_rng_state=False)
                for a in args_per_group]
    return [fn(*a) for a in args_per_group]


def render_windowed(plan: Plan, field,
                    schedule: WindowedSchedule | None = None,
                    jitter: np.ndarray | None = None,
                    remat: bool | None = None,
                    k=None, c2w=None, ortho_scale=None,
                    use_kernel: bool = True) -> ImagePlanes:
    """Window-clipped render of an OOB_ZERO field (generated rays),
    differentiable in the field and, through ``k`` / ``c2w`` /
    ``ortho_scale`` tensors, in the camera at the schedule's camera (the
    windows were built for the plan's camera: a camera far from it needs
    a new schedule).

    ``schedule``: built here from the field's bbox and ``jitter`` (the
    plan's host table) when None; it must be on the field's device. A
    group without jitter rows hashes the plan's stratified jitter on the
    device, so ``jitter`` is refused beside a prebuilt schedule that has
    such a group (JAX gathers that group's rows from it). ``remat`` None recomputes the groups in the backward when the
    frame's residuals would pass 4 GiB. ``use_kernel=False`` integrates
    with the plain integrator (the reference K9f / K9b are held to)."""
    if schedule is None:
        schedule = build_schedule(plan, field.bbox_min, field.bbox_max,
                                  jitter=jitter, device=field.device)
    else:
        check(jitter is None or all(g[3] is not None
                                    for g in schedule.groups),
              "jitter= beside a prebuilt windowed schedule whose groups "
              "carry no jitter rows: those groups hash the plan's jitter; "
              "build the schedule with the table instead")
    return render_windowed_traced(plan, field, schedule, remat=remat, k=k,
                                  c2w=c2w, ortho_scale=ortho_scale,
                                  use_kernel=use_kernel)


def render_windowed_traced(plan: Plan, field, schedule: WindowedSchedule,
                           remat: bool | None = None, k=None, c2w=None,
                           ortho_scale=None,
                           use_kernel: bool = True) -> ImagePlanes:
    """:func:`render_windowed` over a prebuilt ``schedule`` (required, on
    the field's device), with JAX's signature. JAX stages this form as one
    traced program for replay; here both run eagerly, and the frame and
    its camera gradients are differentiable alike."""
    _check_window_field(field)
    device = field.device
    check(not schedule.groups or schedule.device == device,
          f"the windowed schedule is on {schedule.device}, the field on "
          f"{device}: move it with .to(device)")
    if not schedule.groups:   # the bbox misses every ray: background
        return _compose_planes(plan, *_empty_parts(device))
    args = [(plan, budget, field, ids, ke, jit_rows, k, c2w, ortho_scale,
             use_kernel) for budget, ids, ke, jit_rows in schedule.groups]
    parts = _run_groups(_group_outputs, args,
                        _remat(schedule.windowed_samples, remat),
                        schedule.windowed_samples)
    trace.stage("compose")
    return _compose_planes(plan, *(torch.cat([p[i] for p in parts])
                                   for i in range(5)))


def _empty_parts(device):
    """Zero-ray parts: composing them gives the background frame."""
    z = torch.zeros((0,), dtype=torch.float32, device=device)
    return (torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((0, 3), dtype=torch.float32, device=device), z, z, z)


def _compose_planes(plan: Plan, pids, rad, tr, op, dep) -> ImagePlanes:
    """Compose per-ray parts; the hitmask is the ROI's (rays that miss
    the bbox are not rendered and keep the background, as in the full
    render)."""
    planes = compose(pids, rad, tr, op, dep, plan.width, plan.height,
                     plan.t_far)
    return dataclasses.replace(planes,
                               hitmask=roi_hitmask(plan, rad.device))


# ------------------------------------------------------ multi-view stack


@dataclass(frozen=True)
class WindowedStackSchedule(_Groups):
    """Every view's rays merged into one windowed schedule: global ray id
    ``v * N + i`` (for full-frame ROIs also the stacked pixel id). Rays
    span cameras, so each group carries its host-built rays: per group
    (budget, ids, k_enter, jitter rows or None, origins (M, 3),
    directions (M, 3), t_far (M,)); pad entries have ``t_far == t_near``
    and an id past the canvas."""

    groups: tuple
    n_views: int
    view_hw: tuple
    total_rays: int
    skipped_rays: int
    full_lattice_samples: int
    windowed_samples: int


def build_stack_schedule(plans, bbox_min, bbox_max, block: int = 32768,
                         jitter: np.ndarray | None = None,
                         device=None) -> WindowedStackSchedule:
    """The merged windowed schedule of same-shape full-frame ``plans``
    that differ only in camera; ``jitter``: one (N, K) host table shared
    by every view. ``device`` as :func:`build_schedule` takes it."""
    p0 = plans[0]
    n = p0.ray_count
    for p in plans:
        check(p.width == p0.width and p.height == p0.height
              and p.roi == p0.roi and p.ray_count == n
              and p.roi.width == p.width and p.roi.height == p.height,
              "stack schedule requires same-shape full-frame plans")
    v_cnt = len(plans)
    vn = v_cnt * n
    o_all = np.zeros((vn, 3), np.float32)
    d_all = np.zeros((vn, 3), np.float32)
    ke_all = np.zeros(vn, np.int32)
    kc_all = np.zeros(vn, np.int32)
    for v, p in enumerate(plans):
        o_all[v * n:(v + 1) * n], d_all[v * n:(v + 1) * n] = _host_rays(p)
        ke_all[v * n:(v + 1) * n], kc_all[v * n:(v + 1) * n] = _windows(
            p, bbox_min, bbox_max)
    if jitter is not None:
        jitter = np.asarray(jitter, np.float32)

    live = np.nonzero(kc_all > 0)[0]
    order = live[np.argsort(-kc_all[live], kind="stable")]
    groups = []
    windowed = 0
    pad_base = vn
    for start in range(0, order.size, block):
        ids = order[start:start + block]
        budget = int(kc_all[ids].max())
        budget = min(-(-budget // _STEP_QUANTUM) * _STEP_QUANTUM,
                     p0.sampling.max_steps)
        group_size = min(block, -(-ids.size // 256) * 256)
        n_pad = group_size - ids.size
        if n_pad:
            ids = np.concatenate([ids, np.arange(pad_base, pad_base + n_pad)])
            pad_base += n_pad
        real = ids < vn
        safe = np.minimum(ids, vn - 1)
        ke = np.where(real, ke_all[safe], 0).astype(np.int32)
        o_g = np.where(real[:, None], o_all[safe], 0.0).astype(np.float32)
        d_g = np.where(real[:, None], d_all[safe], 0.0).astype(np.float32)
        tf = np.where(real, np.float32(p0.t_far),
                      np.float32(p0.t_near)).astype(np.float32)
        jit_rows = (None if jitter is None
                    else _jitter_rows(jitter, safe % n, ke, budget))
        groups.append((budget, ids.astype(np.int32), ke, jit_rows, o_g, d_g,
                       tf))
        windowed += ids.size * budget
    sched = WindowedStackSchedule(
        groups=tuple(groups), n_views=v_cnt, view_hw=(p0.height, p0.width),
        total_rays=vn, skipped_rays=vn - int(live.size),
        full_lattice_samples=vn * p0.sampling.max_steps,
        windowed_samples=windowed)
    return _placed(sched, device)


def _stack_group_outputs(plan: Plan, budget: int, field, ids, k_enter,
                         block_jitter, o, d, tf, use_kernel: bool = True):
    """:func:`_window_parts` over a stack group's host-built rays."""
    trace.stage("eval")
    m = int(ids.shape[0])
    rays = Rays(origins=o, directions=d,
                t_near=torch.full((m,), float(plan.t_near),
                                  dtype=torch.float32, device=o.device),
                t_far=tf, pixel_ids=ids)
    # the jitter is keyed on the per-view ray id: every view draws one
    # pattern
    return _window_parts(plan, budget, field, rays,
                         ids.to(torch.int64) % plan.ray_count, k_enter,
                         block_jitter, use_kernel)


def render_windowed_stack(plan: Plan, field, schedule: WindowedStackSchedule,
                          remat: bool | None = None,
                          use_kernel: bool = True) -> torch.Tensor:
    """The (V, H, W, 3) radiance stack through the merged schedule, equal
    to stacking the per-view windowed renders; ``plan`` is any view's
    plan (its rays are baked in the schedule). Differentiable in the
    field."""
    _check_window_field(field)
    v_cnt = schedule.n_views
    h, w = schedule.view_hw
    if not schedule.groups:
        return torch.zeros((v_cnt, h, w, 3), dtype=torch.float32,
                           device=field.device)
    check(schedule.device == field.device,
          f"the stack schedule is on {schedule.device}, the field on "
          f"{field.device}: move it with .to(device)")
    args = [(plan, budget, field, ids, ke, jit_rows, o, d, tf, use_kernel)
            for budget, ids, ke, jit_rows, o, d, tf in schedule.groups]
    parts = _run_groups(_stack_group_outputs, args,
                        _remat(schedule.windowed_samples, remat),
                        schedule.windowed_samples)
    trace.stage("compose")
    pids, rad, tr, op, dep = (torch.cat([p[i] for p in parts])
                              for i in range(5))
    planes = compose(pids, rad, tr, op, dep, w, v_cnt * h, plan.t_far)
    return planes.image.reshape(v_cnt, h, w, 3)
