"""Sample lattice: fixed-dt ray marching on a dense (N, K) grid.

Counterpart of ``dvren_tpu/ops/sampling.py`` (the original's
``samp_generate_cpu``, samp_cpu.cpp:151-313): every ray owns K slots and
a boolean mask marks its live samples, a prefix of the ray:

- ``base_t = t_near + step * dt``; live iff ``base_t < t_far``,
  ``t_far > t_near`` and ``step < max_steps``;
- jitter 0.5 (FIXED) or the stratified splitmix64 table, clamped to [0, 1];
- ``sample_t = base_t + jitter * dt``, nudged to ``nextafter(t_far,
  t_near)`` where it lands at or past t_far;
- ``dt = min(base_t + dt, t_far) - base_t`` on live samples, 0 elsewhere;
- positions ``origin + direction * sample_t`` as three coordinate planes.

Without a jitter table a stratified lattice hashes its jitter where its
rays live (:func:`dvren_tpu_torch.ops.rng.stratified_jitter`: the jitter
kernel on CUDA tensors), as JAX hashes it inside the graph, at the
indices clamped into the plan's host table, so the lattice equals the
table route's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch.core.plan import Plan, SamplingMode
from dvren_tpu_torch.ops import rng
from dvren_tpu_torch.ops.raygen import Rays


@dataclass(frozen=True)
class SampleLattice:
    """t, dt, px, py, pz: (N, K) float32; mask (N, K) bool."""

    t: torch.Tensor
    dt: torch.Tensor
    mask: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor

    @property
    def positions(self) -> torch.Tensor:
        """(N, K, 3) positions."""
        return torch.stack([self.px, self.py, self.pz], dim=-1)

    @property
    def position_planes(self) -> tuple:
        return (self.px, self.py, self.pz)

    @property
    def num_rays(self) -> int:
        return int(self.t.shape[0])

    @property
    def max_steps(self) -> int:
        return int(self.t.shape[1])

    def sample_count(self) -> torch.Tensor:
        """Total live samples (a 0-d int tensor)."""
        return torch.sum(self.mask.to(torch.int32))

    def ray_offsets(self) -> torch.Tensor:
        """(N+1,) int32 prefix offsets of the live samples, row-major."""
        per_ray = torch.sum(self.mask.to(torch.int32), dim=1)
        return torch.cat([per_ray.new_zeros(1),
                          torch.cumsum(per_ray, 0).to(torch.int32)])


def generate_samples(plan: Plan, rays: Rays,
                     ray_index_offset: torch.Tensor | int = 0,
                     jitter: torch.Tensor | None = None,
                     step_offset: torch.Tensor | None = None,
                     num_steps: int | None = None) -> SampleLattice:
    """March each ray with fixed dt; the lattice lives on the rays' device.

    ``ray_index_offset`` (an int or an (N,) tensor) shifts the ray indices
    that key the stratified jitter, so a block of rays draws the jitter of
    its global rays. ``jitter`` (N, K): precomputed rows, which take
    precedence; without them a stratified plan's jitter is hashed on the
    rays' device. ``step_offset`` (N,): each ray's first global step (the
    window-clipped path), slot j covering step ``step_offset + j`` over
    ``num_steps`` slots (default ``max_steps``); the global lattice, its
    jitter keying and the max_steps bound are kept, so the window's
    samples equal the full lattice's."""
    dev = rays.origins.device
    dt_step = float(np.float32(plan.sampling.dt))
    k_steps = plan.sampling.max_steps if num_steps is None else int(num_steps)
    n = rays.count

    steps = torch.arange(k_steps, dtype=torch.int32, device=dev)
    t_near = rays.t_near[:, None]
    t_far = rays.t_far[:, None]
    if step_offset is not None:
        steps2d = steps[None, :] + step_offset.to(torch.int32)[:, None]
    else:
        steps2d = steps[None, :].expand(n, k_steps)
    base_t = t_near + steps2d.to(torch.float32) * dt_step
    ray_valid = t_far > t_near
    mask = ((base_t < t_far) & ray_valid
            & (steps2d < plan.sampling.max_steps))

    if jitter is not None:
        jit = jitter.to(device=dev, dtype=torch.float32)
    elif plan.sampling.mode == SamplingMode.STRATIFIED:
        ray_idx = torch.arange(n, dtype=torch.int64, device=dev)
        if isinstance(ray_index_offset, torch.Tensor):
            ray_idx = ray_idx + ray_index_offset.to(device=dev,
                                                    dtype=torch.int64)
        else:
            ray_idx = ray_idx + int(ray_index_offset)
        jit = rng.stratified_jitter(
            plan.seed, ray_idx[:, None], steps2d,
            bounds=(plan.ray_count, plan.sampling.max_steps))
    else:
        jit = torch.full((1, 1), 0.5, dtype=torch.float32, device=dev)
    jit = torch.clamp(jit, 0.0, 1.0)

    sample_t = base_t + jit * dt_step
    nudged = torch.nextafter(t_far, t_near)
    sample_t = torch.where(sample_t >= t_far, nudged.expand_as(sample_t),
                           sample_t)
    dt_actual = torch.minimum(base_t + dt_step, t_far) - base_t
    dt_actual = torch.where(mask, dt_actual, torch.zeros_like(dt_actual))

    o = rays.origins
    d = rays.directions
    px = o[:, 0:1] + d[:, 0:1] * sample_t
    py = o[:, 1:2] + d[:, 1:2] * sample_t
    pz = o[:, 2:3] + d[:, 2:3] * sample_t
    return SampleLattice(t=sample_t, dt=dt_actual, mask=mask,
                         px=px, py=py, pz=pz)
