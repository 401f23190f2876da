"""The dense-lattice render pipeline: raygen -> sampling -> field ->
integrate -> compose.

Counterpart of ``dvren_tpu/render/pipeline.py``. :func:`render` runs the
whole lattice of a plan in one pass; :func:`render_streamed` runs it in
fixed blocks of rays, each recomputed in the backward
(``torch.utils.checkpoint``, where JAX remats), so peak memory is one
block's lattice. Both are differentiable in the field and the camera
tensors. The integrator is the port's per-ray integrator
(:func:`dvren_tpu_torch.ops.integrate_fused.integrate_fused`: K9f / K9b on
CUDA tensors) unless ``use_kernel=False``, which runs the plain
:func:`dvren_tpu_torch.ops.integrate.integrate` on any device: the
referee the windowed path is held to.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dvren_tpu_torch.core.plan import Plan, SamplingMode
from dvren_tpu_torch.ops import rng
from dvren_tpu_torch.ops.compose import ImagePlanes, compose
from dvren_tpu_torch.ops.integrate import Integration, integrate
from dvren_tpu_torch.ops.integrate_fused import integrate_fused
from dvren_tpu_torch.ops.raygen import Rays, generate_rays
from dvren_tpu_torch.ops.sampling import SampleLattice, generate_samples


@dataclass(frozen=True)
class RenderOutputs:
    """Everything a forward produces; ``color`` is three (N, K) planes."""

    rays: Rays
    lattice: SampleLattice
    sigma: torch.Tensor
    color: tuple
    intl: Integration
    planes: ImagePlanes


def plan_jitter_table(plan: Plan) -> np.ndarray | None:
    """Host stratified jitter (N, K) for a plan; None for FIXED mode.

    Cached on (seed, rays, steps): the table does not depend on the
    camera. The cached array is read-only; copy before mutating."""
    if plan.sampling.mode != SamplingMode.STRATIFIED:
        return None
    return _jitter_table_cached(plan.seed, plan.ray_count,
                                plan.sampling.max_steps)


@functools.lru_cache(maxsize=2)
def _jitter_table_cached(seed: int, n_rays: int, n_steps: int):
    table = rng.jitter_table(seed, n_rays, n_steps)
    table.setflags(write=False)
    return table


def eval_fields(field, lattice: SampleLattice):
    """(sigma, (r, g, b)) planes of ``field`` at the lattice's positions,
    zero on masked slots: the packed-stencil route where the field has
    one, else its sigma and colour evaluators."""
    px, py, pz = lattice.position_planes
    if getattr(field, "supports_packed_eval", False):
        sigma, cr, cg, cb = field.packed_eval_planes(px, py, pz)
    else:
        sigma = field.sigma_at_planes(px, py, pz)
        cr, cg, cb = field.color_at_planes(px, py, pz)
    maskf = lattice.mask.to(sigma.dtype)
    return sigma * maskf, (cr * maskf, cg * maskf, cb * maskf)


def integrate_heads(sigma, color, lattice: SampleLattice, t_near: float,
                    t_far: float, t_origin=None,
                    use_kernel: bool = True) -> Integration:
    """The :class:`Integration` of a lattice's planes: the port's per-ray
    integrator (no aux), or with ``use_kernel=False`` the plain one with
    its (N, K, 4) aux."""
    if use_kernel:
        rad, t, op, dep = integrate_fused(sigma, color, lattice.dt,
                                          lattice.mask, t_near, t_far,
                                          t_origin=t_origin)
        return Integration(radiance=rad, transmittance=t, opacity=op,
                           depth=dep, aux=None)
    return integrate(sigma, color, lattice.dt, lattice.mask, t_near, t_far,
                     t_cursor_origin=t_origin)


def _device_of(field):
    return getattr(field, "device", None)


def render(plan: Plan, field, k=None, c2w=None, ortho_scale=None,
           rays: Rays | None = None, jitter=None,
           use_kernel: bool = True) -> RenderOutputs:
    """The full forward of a plan's lattice. ``rays`` overrides the
    generated rays (the hp_ray override path: its rays may share pixels,
    and the compose then accumulates them, ``unique_pixels=False``);
    camera tensors default to the plan's camera, and generated rays live
    on the field's device. ``jitter``: the (N, K) table
    (:func:`plan_jitter_table`, or for an override bundle the table of its
    own size), else hashed on the rays' device
    (:func:`dvren_tpu_torch.ops.rng.stratified_jitter`). The depth cursor
    starts at ``plan.t_near`` for every ray, an override's too, as in JAX.
    ``use_kernel=False`` integrates with the plain integrator and keeps
    its aux; otherwise ``intl.aux`` is None."""
    unique_pixels = rays is None    # generated rays enumerate the ROI
    if rays is None:
        rays = generate_rays(plan, k=k, c2w=c2w, ortho_scale=ortho_scale,
                             device=_device_of(field))
    if jitter is not None and not isinstance(jitter, torch.Tensor):
        jitter = torch.from_numpy(np.array(jitter, np.float32))
    if jitter is not None:
        jitter = jitter.to(rays.origins.device)
    lattice = generate_samples(plan, rays, jitter=jitter)
    sigma, color = eval_fields(field, lattice)
    intl = integrate_heads(sigma, color, lattice, plan.t_near, plan.t_far,
                           use_kernel=use_kernel)
    planes = compose(rays.pixel_ids, intl.radiance, intl.transmittance,
                     intl.opacity, intl.depth, plan.width, plan.height,
                     plan.t_far, unique_pixels=unique_pixels)
    return RenderOutputs(rays=rays, lattice=lattice, sigma=sigma,
                         color=color, intl=intl, planes=planes)


def render_image(plan: Plan, field, **kwargs) -> torch.Tensor:
    """(H, W, 3) radiance image."""
    return render(plan, field, **kwargs).planes.image


def default_ray_tile(plan: Plan, budget_samples: int = 1 << 22) -> int:
    """Rays per block so one block's lattice holds about
    ``budget_samples`` samples."""
    k = plan.sampling.max_steps
    tile = max(1, budget_samples // max(k, 1))
    return int(min(tile, plan.ray_count))


def render_streamed(plan: Plan, field, k=None, c2w=None, ortho_scale=None,
                    ray_tile: int | None = None, jitter=None,
                    remat: bool = True,
                    use_kernel: bool = True) -> ImagePlanes:
    """:func:`render` in blocks of ``ray_tile`` rays (default
    :func:`default_ray_tile`), the same values per ray (the stratified
    jitter is keyed on the global ray index: rows of ``jitter`` when
    given, else hashed on the device per block). With ``remat`` each
    block's lattice is recomputed in the backward instead of kept."""
    tile = ray_tile or default_ray_tile(plan)
    n = plan.ray_count
    n_tiles = -(-n // tile)
    device = _device_of(field)
    table = None
    if jitter is not None:
        table = (jitter if isinstance(jitter, torch.Tensor)
                 else torch.from_numpy(np.array(jitter, np.float32)))
        if table.shape[0] < n_tiles * tile:
            table = torch.cat([table, table.new_zeros(
                (n_tiles * tile - table.shape[0], table.shape[1]))])

    def block(start, block_jitter, *cam):
        kk, cc, oo = cam
        rays = generate_rays(plan, k=kk, c2w=cc, ortho_scale=oo,
                             start=start, count=tile, device=device)
        lattice = generate_samples(plan, rays, ray_index_offset=start,
                                   jitter=block_jitter)
        sigma, color = eval_fields(field, lattice)
        intl = integrate_heads(sigma, color, lattice, plan.t_near,
                               plan.t_far, use_kernel=use_kernel)
        return (rays.pixel_ids, intl.radiance, intl.transmittance,
                intl.opacity, intl.depth)

    parts = []
    for i in range(n_tiles):
        start = i * tile
        bj = None
        if table is not None:
            bj = table[start:start + tile].to(device)
        if remat and torch.is_grad_enabled():
            # no random draws to replay (the jitter is a table), and a
            # CUDA graph cannot record the RNG state's save
            out = checkpoint(block, start, bj, k, c2w, ortho_scale,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            out = block(start, bj, k, c2w, ortho_scale)
        parts.append(out)
    cat = [torch.cat([p[i] for p in parts]) for i in range(5)]
    return compose(*cat, plan.width, plan.height, plan.t_far)
