"""Camera ray generation: pinhole and orthographic, ROI-aware, differentiable.

Counterpart of ``dvren_tpu/ops/raygen.py``: one vectorised torch program
over the requested rays, with the intrinsics ``k``, the extrinsics
``c2w`` and ``ortho_scale`` as tensors, so that autograd gives camera
gradients. The 3x3 rotation is applied with explicit component math (no
matmul), as the JAX package does, so the rays stay full float32 and
match it to rounding.

Orthographic rays follow the CUDA convention of the original renderer:
the origin moves in the camera plane by ``ortho_scale``, with no +0.5
pixel-centre offset.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dvren_tpu_torch.core.context import resolve_device
from dvren_tpu_torch.core.plan import CameraModel, Plan

_FLT_MIN = 1.1754943508222875e-38  # std::numeric_limits<float>::min()


@dataclass(frozen=True)
class Rays:
    """Ray bundle: origins / directions (N, 3) float32, t_near / t_far
    (N,) float32, pixel_ids (N,) int32 with pixel_id = py * width + px."""

    origins: torch.Tensor
    directions: torch.Tensor
    t_near: torch.Tensor
    t_far: torch.Tensor
    pixel_ids: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.origins.shape[0])


def camera_arrays(plan: Plan, device=None):
    """The plan's camera as float32 tensors: k (3, 3), c2w (3, 4) and
    ortho_scale ()."""
    k = torch.tensor(plan.camera.k, dtype=torch.float32,
                     device=device).reshape(3, 3)
    c2w = torch.tensor(plan.camera.c2w, dtype=torch.float32,
                       device=device).reshape(3, 4)
    ortho_scale = torch.tensor(plan.camera.ortho_scale, dtype=torch.float32,
                               device=device)
    return k, c2w, ortho_scale


def generate_rays(plan: Plan, k: torch.Tensor | None = None,
                  c2w: torch.Tensor | None = None,
                  ortho_scale: torch.Tensor | None = None,
                  start: int = 0, count: int | None = None,
                  ids: torch.Tensor | None = None,
                  device=None) -> Rays:
    """Rays for ROI pixels, row-major over (roi.height, roi.width).

    ``k``, ``c2w`` and ``ortho_scale`` default to the plan's camera and
    may be tensors that autograd records. ``start`` / ``count`` select a
    contiguous block of rays; entries past the ROI are degenerate padding
    rays (t_far == t_near, pixel id past the frame). ``ids`` (integer
    tensor of global ray indices) overrides both. The rays live on the
    device of ``ids``, else of ``k`` / ``c2w`` / ``ortho_scale``, else on
    ``device``, which defaults as :class:`~dvren_tpu_torch.Context`'s does:
    CUDA unless the caller names ``"cpu"``."""
    for x in (ids, k, c2w, ortho_scale):
        if isinstance(x, torch.Tensor):
            device = x.device
            break
    else:
        device = resolve_device(device)
    if k is None or c2w is None or ortho_scale is None:
        dk, dc2w, ds = camera_arrays(plan, device)
        k = dk if k is None else k
        c2w = dc2w if c2w is None else c2w
        ortho_scale = ds if ortho_scale is None else ortho_scale
    k = torch.as_tensor(k, dtype=torch.float32, device=device).reshape(3, 3)
    c2w = torch.as_tensor(c2w, dtype=torch.float32,
                          device=device).reshape(3, 4)

    roi = plan.roi
    if ids is not None:
        global_idx = ids.to(device=device, dtype=torch.int64).reshape(-1)
    else:
        n = plan.ray_count if count is None else int(count)
        global_idx = torch.arange(start, start + n, dtype=torch.int64,
                                  device=device)
    n = int(global_idx.shape[0])
    in_roi = global_idx < plan.ray_count
    local = torch.clamp(global_idx, max=plan.ray_count - 1)
    local_x = local % roi.width
    local_y = local // roi.width
    px = (roi.x + local_x).to(torch.float32)
    py = (roi.y + local_y).to(torch.float32)

    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    rot = c2w[:, :3]
    trans = c2w[:, 3]

    if plan.camera.model == CameraModel.PINHOLE:
        # pixel-centre convention (+0.5)
        a = ((px + 0.5) - cx) / fx
        b = ((py + 0.5) - cy) / fy
        dir_world = torch.stack(
            [rot[0, 0] * a + rot[0, 1] * b + rot[0, 2],
             rot[1, 0] * a + rot[1, 1] * b + rot[1, 2],
             rot[2, 0] * a + rot[2, 1] * b + rot[2, 2]], dim=-1)
        origins = trans.expand(n, 3)
    else:
        dir_world = rot[:, 2].expand(n, 3)
        u = (px - cx) / fx * ortho_scale
        v = (py - cy) / fy * ortho_scale
        origins = trans + torch.stack(
            [rot[0, 0] * u + rot[0, 1] * v,
             rot[1, 0] * u + rot[1, 1] * v,
             rot[2, 0] * u + rot[2, 1] * v], dim=-1)

    len_sq = (dir_world[:, 0] * dir_world[:, 0]
              + dir_world[:, 1] * dir_world[:, 1]
              + dir_world[:, 2] * dir_world[:, 2])[:, None]
    inv_len = 1.0 / torch.sqrt(torch.clamp_min(len_sq, _FLT_MIN))
    directions = dir_world * inv_len

    t_near = torch.full((n,), float(plan.t_near), dtype=torch.float32,
                        device=device)
    t_far = torch.where(in_roi, torch.full_like(t_near, float(plan.t_far)),
                        t_near)
    pixel_ids = (roi.y + local_y) * plan.width + (roi.x + local_x)
    pad_ids = plan.width * plan.height + (global_idx - plan.ray_count)
    pixel_ids = torch.where(in_roi, pixel_ids, pad_ids).to(torch.int32)
    return Rays(origins=origins, directions=directions, t_near=t_near,
                t_far=t_far, pixel_ids=pixel_ids)


def validate_override(plan: Plan, rays: Rays) -> Rays:
    """Check a caller's ray bundle (the hp_ray override path,
    ray_cpu.cpp:148-150): (N <= max_rays, ...) shapes that agree, with
    the JAX package's messages."""
    n = int(rays.origins.shape[0])
    if (tuple(rays.origins.shape) != (n, 3)
            or tuple(rays.directions.shape) != (n, 3)):
        raise ValueError("override rays origins/directions must be (N, 3)")
    if tuple(rays.t_near.shape) != (n,) or tuple(rays.t_far.shape) != (n,):
        raise ValueError("override rays t_near/t_far must be (N,)")
    if tuple(rays.pixel_ids.shape) != (n,):
        raise ValueError("override rays pixel_ids must be (N,)")
    if n > plan.max_rays:
        raise ValueError(f"override ray count {n} exceeds max_rays "
                         f"{plan.max_rays}")
    return rays
