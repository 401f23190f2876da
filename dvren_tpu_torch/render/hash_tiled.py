"""Hash-MLP tiled rendering: the slot-free fused fast path.

Counterpart of the fused half of ``dvren_tpu/render/hash_tiled.py``.
Unlike the dense path's cell tables (:mod:`dvren_tpu_torch.render.tiled`),
the hash kernels (:mod:`dvren_tpu_torch.ops.hash_tiles`) resolve their
table lookups inside the kernel, so the schedule is only the frame's tile
layout: sample_t planes and compact ray planes per (tile, chunk). It
depends on (plan, camera) and never on the field. It is built in numpy,
as the JAX package builds it, and moved to the device once
(:meth:`HashTiledSchedule.to`); its arrays equal that package's, with
sample_t kept as float32 where the TPU splits it into u16 hi | lo halves
(bit-equal after recombining).

The composition reuses the dense path's tile composer: the kernel's
(16, 16) output blocks are image tiles.

The NGP-scale grid half (``build_hash_grid_schedule``,
``render_hash_grid_tiled``) rides K8 and is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops.compose import ImagePlanes
from dvren_tpu_torch.ops.hash_tiles import (fast_path_ok,
                                            render_hash_tile_group_raw)
from dvren_tpu_torch.render import tiled as tiled_mod
from dvren_tpu_torch.render import windowed as windowed_mod
from dvren_tpu_torch.render.pipeline import plan_jitter_table

_DROP_TILE = tiled_mod._DROP_TILE
_TODO_GRID = ("the NGP-scale hash grid path (K8) is ROADMAP Queue 1 "
              "item 14")


def _arrays_to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: tiled_mod._to_device(getattr(obj, f.name), device)
        for f in dataclasses.fields(obj)})


@dataclass(frozen=True)
class HashTiledSchedule:
    """One group of 16x16-pixel tiles over the full lattice (hash fields
    have no bbox to clip against). Pad rays (ROI edges) carry sample_t
    past t_far. Fields are numpy arrays as built, or tensors after
    :meth:`to`."""

    n_chunks: int
    n_tiles: int
    samp: np.ndarray        # (T, nc, 16, 128) f32 sample_t
    rayt: np.ndarray        # (T, 12, 128) f32 compact ray planes
    tile_ids: np.ndarray    # (T,) int32 image-tile ids (pads: 1 << 30)

    def to(self, device) -> "HashTiledSchedule":
        return _arrays_to(self, device)

    @property
    def device(self):
        """The device of the arrays, or None while they are numpy."""
        return (self.samp.device if isinstance(self.samp, torch.Tensor)
                else None)


def build_hash_schedule(plan: Plan, jitter: np.ndarray | None = None,
                        device=None) -> HashTiledSchedule:
    """Tile/block layout for the hash fast path, in numpy.

    ``jitter``: the (N, K) host table of a stratified plan
    (:func:`plan_jitter_table`; built from the plan when omitted); FIXED
    plans bake jitter 0.5. ``device``: where to put the arrays (None
    keeps numpy, for stack merging: upload once after the concat)."""
    if jitter is None:
        jitter = plan_jitter_table(plan)

    n = plan.ray_count
    k_max = int(plan.sampling.max_steps)
    nc = -(-k_max // 8)
    k_steps = nc * 8
    dt = np.float32(plan.sampling.dt)
    t_near = np.float32(plan.t_near)
    t_far = np.float32(plan.t_far)

    o, d = windowed_mod._host_rays(plan)
    tiles, sub_ids = tiled_mod._tile_rays(plan)        # (T, 256), (T, 1)
    t_cnt = tiles.shape[0]
    safe = np.maximum(tiles, 0)
    live_r = tiles >= 0

    k = np.arange(k_steps, dtype=np.int64)
    base_t = t_near + k.astype(np.float32) * dt        # (K,)
    if jitter is not None:
        jit = np.asarray(jitter, np.float32)[
            np.minimum(safe, n - 1)[:, :, None],
            np.minimum(k, np.asarray(jitter).shape[1] - 1)]
    else:
        jit = np.float32(0.5)
    st = np.asarray(base_t[None, None, :] + jit * dt, np.float32)
    st = np.broadcast_to(st, (t_cnt, 256, k_steps))
    # dead pad rays march anyway and the compose crops them; their
    # sample_t lies past t_far
    st = np.where(live_r[:, :, None], st, np.float32(t_far + 1.0))
    samp = st.reshape(t_cnt, 16, 16, nc, 8).transpose(0, 3, 1, 2, 4) \
        .reshape(t_cnt, nc, 16, 128)

    ot = o[safe].astype(np.float32, copy=False)
    dtn = d[safe].astype(np.float32, copy=False)
    rayt = np.stack(
        [ot[:, :, i].reshape(t_cnt, 2, 128) for i in range(3)]
        + [dtn[:, :, i].reshape(t_cnt, 2, 128) for i in range(3)],
        axis=1).reshape(t_cnt, 12, 128)

    # pad the group to a multiple of 8 tiles: pad tiles march zero rays
    # at the origin and the compose drops them (id 1 << 30)
    t_pad = -(-t_cnt // 8) * 8
    tile_ids = sub_ids.reshape(-1).astype(np.int32)
    if t_pad != t_cnt:
        extra = t_pad - t_cnt
        samp = np.concatenate(
            [samp, np.zeros((extra,) + samp.shape[1:], np.float32)])
        rayt = np.concatenate([rayt, np.zeros((extra, 12, 128), np.float32)])
        tile_ids = np.concatenate(
            [tile_ids, np.full(extra, _DROP_TILE, np.int32)])
    sched = HashTiledSchedule(
        n_chunks=nc, n_tiles=t_pad, samp=np.ascontiguousarray(samp),
        rayt=np.ascontiguousarray(rayt), tile_ids=tile_ids)
    return sched if device is None else sched.to(device)


@dataclass(frozen=True)
class HashStackSchedule:
    """V per-view hash schedules concatenated on the tile axis: one kernel
    launch marches every view's tiles, then a per-view compose takes its
    ``n_tiles``-tile span. All views share the plan's frame geometry."""

    n_chunks: int
    n_tiles: int            # tiles per view (padded)
    n_views: int
    samp: np.ndarray        # (V*T, nc, 16, 128) f32
    rayt: np.ndarray        # (V*T, 12, 128) f32
    tile_ids: np.ndarray    # (V*T,) int32, per-view frame-local ids

    def to(self, device) -> "HashStackSchedule":
        return _arrays_to(self, device)

    @property
    def device(self):
        return (self.samp.device if isinstance(self.samp, torch.Tensor)
                else None)


def build_hash_schedule_stack(plans, jitter: np.ndarray | None = None,
                              device=None) -> HashStackSchedule:
    """Concatenate per-view hash schedules (same frame geometry) for
    :func:`render_hash_tiled_stack`, in numpy until the one move to
    ``device``."""
    check(len(plans) >= 1, "need at least one view")
    per = [build_hash_schedule(p, jitter=jitter) for p in plans]
    nc, nt = per[0].n_chunks, per[0].n_tiles
    check(all(s.n_chunks == nc and s.n_tiles == nt for s in per),
          "hash stack views must share the plan's frame geometry")
    stack = HashStackSchedule(
        n_chunks=nc, n_tiles=nt, n_views=len(per),
        samp=np.concatenate([s.samp for s in per]),
        rayt=np.concatenate([s.rayt for s in per]),
        tile_ids=np.concatenate([s.tile_ids for s in per]))
    return stack if device is None else stack.to(device)


def _check_field(field, schedule):
    check(fast_path_ok(field.spec),
          "hash fast path unavailable for this spec (power-of-two "
          "table_size <= 128, hidden_dim <= 8)")
    check(schedule.device == field.device,
          f"schedule is on {schedule.device}, the field on {field.device}: "
          f"move it with schedule.to(device)")


def render_hash_tiled_stack(plan: Plan, field, stack: HashStackSchedule,
                            use_kernel: bool = True) -> torch.Tensor:
    """Render every view in one fused kernel launch -> (V, H, W, 3) image
    stack (the multi-view training step's hot path; differentiable in the
    field's parameters)."""
    _check_field(field, stack)
    raw = render_hash_tile_group_raw(plan, field.spec, stack.samp,
                                     stack.rayt, dict(field.params),
                                     stack.n_chunks, use_kernel=use_kernel)
    images = []
    for v in range(stack.n_views):
        sl = slice(v * stack.n_tiles, (v + 1) * stack.n_tiles)
        planes = tiled_mod._compose_tiles(plan, [raw[sl]],
                                          [stack.tile_ids[sl]])
        images.append(planes.image)
    return torch.stack(images)


def render_hash_tiled(plan: Plan, field, schedule: HashTiledSchedule,
                      use_kernel: bool = True) -> ImagePlanes:
    """Fused hash-MLP forward render, differentiable in the field's
    parameters. ``use_kernel=False`` runs the plain twins of K7f / K7b on
    the schedule's device."""
    _check_field(field, schedule)
    raw = render_hash_tile_group_raw(plan, field.spec, schedule.samp,
                                     schedule.rayt, dict(field.params),
                                     schedule.n_chunks,
                                     use_kernel=use_kernel)
    return tiled_mod._compose_tiles(plan, [raw], [schedule.tile_ids])


def build_hash_grid_schedule(*args, **kwargs):
    raise NotImplementedError(_TODO_GRID)


def render_hash_grid_tiled(*args, **kwargs):
    raise NotImplementedError(_TODO_GRID)
