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

The NGP-scale grid half (:func:`build_hash_grid_schedule`,
:func:`render_hash_grid_tiled`, counterpart of the JAX module's grid
path) carries table sizes past 128: the dense scheduler over the finest
level's point lattice, cascading 16 -> 8 -> 4 px sub-tiles until no slot
table overflows, the packed multi-level corner table of
:mod:`dvren_tpu_torch.ops.hash_grid`, the bank gather at C = L*8*F
columns, and K8f / K8b per tile group, in the schedule's sub-tile form,
inside one autograd node (:class:`_HashGridGroupset`). The field is zero
outside the unit cube.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops import hash_grid
from dvren_tpu_torch.ops.compose import ImagePlanes
from dvren_tpu_torch.ops.gather_plan import slot_rows_to_table
from dvren_tpu_torch.ops.hash_tiles import (MLP_KEYS, fast_path_ok,
                                            grads_from_blocks,
                                            pack_mlp_scalars,
                                            render_hash_tile_group_raw)
from dvren_tpu_torch.render import tiled as tiled_mod
from dvren_tpu_torch.render import windowed as windowed_mod
from dvren_tpu_torch.render.pipeline import plan_jitter_table

_DROP_TILE = tiled_mod._DROP_TILE


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


# -------------------------------------------------- NGP-scale grid path


@dataclass(frozen=True)
class _HashSchedProxy:
    """The scheduler's view of a hash-MLP field on the grid path: the unit
    bbox (the reference fixes field bounds to [0, 1]^3) and the finest
    level's point lattice as the cell grid. The grid path defines the
    field as zero outside the unit cube."""

    schedule_grid_shape: tuple
    bbox_min: tuple = (0.0, 0.0, 0.0)
    bbox_max: tuple = (1.0, 1.0, 1.0)


def _check_grid_spec(spec):
    check(hash_grid.grid_path_ok(spec),
          "hash grid path unavailable for this spec: it needs explicit "
          "integer power-of-two ladder resolutions with finest <= 64 "
          "(HashMLPSpec.resolutions), hidden_dim <= 8 and encoding_dim <= 64")


def build_hash_grid_schedule(plan: Plan, field,
                             jitter: np.ndarray | None = None,
                             tile_px: int | None = None,
                             quantize=False,
                             uniform_shape=None,
                             device=None) -> tiled_mod.TiledSchedule:
    """Tile-table schedule for the hash grid path: the dense scheduler over
    the spec's finest-level lattice (one slot per finest cell; every
    level's lookups resolve from that cell's packed row), in numpy, or
    moved to ``device``.

    ``tile_px`` 16, 8 or 4 builds that size; ``None`` cascades 16 -> 8 ->
    4 px sub-tiles and keeps the first size with zero slot overflow (the
    grid path has no windowed fallback: the streamed referee's semantics
    outside the unit cube differ). A scene that overflows even 4 px
    sub-tiles raises ``DvrenError``. ``quantize`` / ``uniform_shape`` as
    in :func:`tiled.build_tiled_schedule`."""
    _check_grid_spec(field.spec)
    proxy = _HashSchedProxy(
        schedule_grid_shape=hash_grid.grid_shape(field.spec))

    def build(px):
        return tiled_mod.build_tiled_schedule(
            plan, proxy, jitter=jitter, tile_px=px, quantize=quantize,
            uniform_shape=uniform_shape)

    if tile_px is not None:
        sched = build(tile_px)
    else:
        for px in (16, 8, 4):
            sched = build(px)
            if sched.fallback_rays == 0:
                break
        check(sched.fallback_rays == 0,
              "hash grid schedule overflows even 4px sub-tiles")
    return sched if device is None else sched.to(device)


class _HashGridGroupset(torch.autograd.Function):
    """Hash-field params -> every tile group's raw K8f output, as one
    autograd node: the counterpart of ``dvren_tpu``'s
    ``render_hash_grid_tiled`` chain (table build, ``_gather_banks_f32``,
    the hash-grid custom VJP per group).

    Forward: :func:`hash_grid.build_hash_grid_table`, the bank gather at
    C columns, K8f per group. Backward: K8b per group, one ``torch.cat``
    of the slot rows, :func:`gather_plan.slot_rows_to_table` over C
    columns, then :func:`hash_grid.hash_grid_table_grad`; the MLP partials
    are summed with ``torch.sum`` and mapped by ``grads_from_blocks``. Autograd
    never records the table gather: its backward would be ``index_add_``.
    Returns None for ``static`` and the params' cotangents in
    ``("hash_table",) + MLP_KEYS`` order. ``static`` = (schedule,
    per-group GridParams, use_kernel, spec); on CPU tensors every kernel
    step runs its plain twin."""

    @staticmethod
    def forward(ctx, static, *params):
        schedule, prms, use_kernel, spec = static
        named = dict(zip(("hash_table",) + MLP_KEYS, params))
        table = hash_grid.build_hash_grid_table(named, spec)
        sc = pack_mlp_scalars(named, spec)
        tabs = tiled_mod._gather_bank_tables(
            table, schedule.gathermap_all,
            [(g.n_tiles, g.banks) for g in schedule.groups])
        forward = (hash_grid.hash_grid_forward if use_kernel
                   else hash_grid.hash_grid_forward_plain)
        raws = tuple(
            forward(tabs[gi], g.samp, g.base, g.rayt, g.k_enter,
                    g.bank0.reshape(-1), sc, prms[gi])
            for gi, g in enumerate(schedule.groups))
        ctx.static = static
        ctx.tabs = tabs
        ctx.n_rows = int(table.shape[0])
        ctx.save_for_backward(sc)
        return raws

    @staticmethod
    def backward(ctx, *g_raws):
        schedule, prms, use_kernel, spec = ctx.static
        (sc,) = ctx.saved_tensors
        backward = (hash_grid.hash_grid_backward if use_kernel
                    else hash_grid.hash_grid_backward_plain)
        rows, d_scs = [], []
        for gi, g in enumerate(schedule.groups):
            gs = g_raws[gi]
            gs = (sc.new_zeros((g.n_tiles, 5, 16, 16)) if gs is None
                  else gs.contiguous())
            d_rows, d_sc = backward(ctx.tabs[gi], g.samp, g.base, g.rayt,
                                    g.k_enter, g.bank0.reshape(-1), sc, gs,
                                    prms[gi])
            rows.append(d_rows.reshape(-1, d_rows.shape[-1]))
            d_scs.append(d_sc)
        table_grad = slot_rows_to_table(
            torch.cat(rows), schedule.gather_plan, ctx.n_rows)
        grads = grads_from_blocks(
            hash_grid.hash_grid_table_grad(table_grad, spec),
            torch.sum(torch.stack(d_scs), dim=0), spec)
        return (None, *(grads[k] for k in ("hash_table",) + MLP_KEYS))


def render_hash_grid_tiled(plan: Plan, field, schedule,
                           use_kernel: bool = True) -> ImagePlanes:
    """NGP-scale fused hash render: the packed multi-level table build, the
    planned bank gather, K8f per tile group and the tile composition.
    Differentiable in the field's parameters (the hash table through K8b's
    slot rows, the planned gather transpose and the table build's
    adjoint; the MLP heads through K8b's scalar gradients).
    ``use_kernel=False`` runs the plain twins of K8f / K8b on the
    schedule's device."""
    _check_grid_spec(field.spec)
    check(schedule.fallback_rays == 0 and schedule.fallback is None,
          "hash grid path requires zero overflow rays")
    check(tuple(schedule.grid_shape) == hash_grid.grid_shape(field.spec),
          "schedule was built for a different finest resolution")
    check(schedule.device == field.device,
          f"schedule is on {schedule.device}, the field on {field.device}: "
          f"move it with schedule.to(device)")
    subs = (16 // schedule.tile_px) ** 2
    prms = tuple(hash_grid.grid_op_params(plan, field.spec, g.banks,
                                          g.n_chunks, subs)
                 for g in schedule.groups)
    raws = []
    if schedule.groups:
        raws = list(_HashGridGroupset.apply(
            (schedule, prms, use_kernel, field.spec),
            *(field.params[k] for k in ("hash_table",) + MLP_KEYS)))
    return tiled_mod._compose_tiles(
        plan, raws, [g.tile_ids for g in schedule.groups],
        tile_px=schedule.tile_px, device=field.device)
