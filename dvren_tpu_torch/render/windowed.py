"""Host ray geometry shared by the schedule builders.

Counterpart of the host half of ``dvren_tpu/render/windowed.py``:
``_host_rays`` (the numpy ray generator that mirrors the device's
rounding), ``_windows`` (each ray's live lattice steps inside the field
bbox) and ``roi_hitmask``. The windowed render itself, which the tiled
path uses for rays whose tiles overflow the slot tables, is not ported
yet (ROADMAP Queue 1 item 11); until it is, schedules with such rays are
refused.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dvren_tpu_torch.core.plan import CameraModel, Plan


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
    generated ray, img_cpu.cpp:169-176), 0 elsewhere."""
    roi = plan.roi
    mask = torch.zeros((plan.height, plan.width), dtype=torch.int32,
                       device=device)
    mask[roi.y:roi.y + roi.height, roi.x:roi.x + roi.width] = 1
    return mask
