"""Tile-table rendering: the host schedule and the device forward.

Counterpart of ``dvren_tpu/render/tiled.py`` for the dense-grid forward.
For a fixed (plan, camera, field bbox and resolution) every sample's cell
is static; only the field values change between frames. The host
therefore resolves the whole access pattern once:

1. it tiles the ROI into 16x16-pixel blocks of 256 rays, each with a
   shared step window [k_enter, k_enter + budget) cut into 8-step chunks;
2. per (tile, chunk) it collects the distinct grid cells the chunk's 2048
   samples touch, packs each chunk's cell run densely into the tile's
   bank space (banks of 128 lanes; a run of <= 128 cells spans at most
   two consecutive banks) and gives every sample its tile-local lane;
3. per sample it ships only sample_t's bits and (lane | mask), plus the
   tile's ray planes and each lane's cell base, from which the kernel
   recomputes the trilinear fractions.

Each frame, the device builds the packed-stencil table (K3,
:mod:`dvren_tpu_torch.ops.packed_transpose`), gathers every tile's bank
block from it, renders each tile group (K1,
:mod:`dvren_tpu_torch.ops.fused_tiles`) and places the (16, 16) output
tiles into the image.

The backward (:class:`_GroupsetFromParams`, what autograd runs through
:func:`render_tiled`) runs K2 per group, which emits each tile's table
gradient as f32 slot rows (and the ray-plane adjoint for camera
gradients), sums the rows of every cell through the schedule's
:class:`~dvren_tpu_torch.ops.gather_plan.GatherPlan` (gathers and sums,
no scatter and no atomics), and unpacks the table gradient onto the grid
with K4. Repeat runs are bit-identical.

That is the dense float32 route on cell tables. Every other case takes
the flat-table route (:class:`_GroupsetFromTable`, from any (R, C)
table): a dense field with a 16-bit ``packed_dtype`` builds its table
with K5a (:class:`_Table16FromParams`, whose backward is K5b); a
supercell schedule (``cell_scale=2``) the 108-column table of
:func:`~dvren_tpu_torch.ops.grid.build_supercell_stencil`; and a
:class:`~dvren_tpu_torch.fields.sparse_grid.SparseGridField` hands over
its bricks as they are, the schedule's lanes naming brick rows.

The schedule is built in numpy, as the JAX package builds it, and its
arrays, the gather plan included, equal that package's array for array.
Tiles of 16, 8 or 4 px (8 and 4 px: sub-tiles of a 16x16 block, each
with its own bank windows), one slot per grid cell or per 2x2x2
supercell, and :func:`build_tiled_schedule_auto`'s cascade over them, as
in the JAX package. Not yet ported: pitch 2, occupancy trimming,
quantized shapes and the windowed fallback, so a schedule whose rays
still overflow cannot be rendered. Those raise ``NotImplementedError``
naming their ROADMAP item.

Sample layout per (tile, chunk): block row r in [0, 16), lane l in
[0, 128), ray_in_tile = r * 16 + l // 8, step = l % 8; with n_sub
sub-tiles, sub-tile s owns the 16 // n_sub rows from s * (16 // n_sub).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch.core.plan import InterpMode, OobPolicy, Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.fields.sparse_grid import BRICK
from dvren_tpu_torch.ops import fused_tiles, packed_transpose
from dvren_tpu_torch.ops.compose import ImagePlanes
from dvren_tpu_torch.ops.gather_plan import (build_gather_plan,
                                             slot_rows_to_table)
from dvren_tpu_torch.ops.grid import (NCH, build_supercell_stencil,
                                      fullpitch_rows, supercell_rows,
                                      table_dtype)
from dvren_tpu_torch.ops.raygen import generate_rays
from dvren_tpu_torch.render import windowed as windowed_mod
from dvren_tpu_torch.render.pipeline import plan_jitter_table

TILE_W = 16
TILE_H = 16
RAYS_PER_TILE = TILE_W * TILE_H
CHUNK = 8
MAX_CELLS = 128
_SENTINEL = np.int64(1) << 62
_DROP_TILE = 1 << 30     # tile id of pad tiles: compose drops it

# ROADMAP Queue 1 items for what this slice leaves out
_TODO_FALLBACK = "the windowed fallback (ROADMAP Queue 1 item 11)"
_TODO_PITCH2 = "pitch-2 packing (ROADMAP Queue 1 item 5)"
_TODO_OCCUPANCY = "occupancy trimming (ROADMAP Queue 1 item 5)"
_TODO_MULTIVIEW = "quantized and uniform schedules (ROADMAP Queue 1 item 13)"


def _to_device(x, device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


@dataclass(frozen=True)
class TileGroup:
    """All tiles sharing one (chunk count, bank count).

    Fields are numpy arrays as built, or tensors after :meth:`to`."""

    n_chunks: int
    n_tiles: int             # padded to a multiple of 8
    banks: int               # banks of 128 lanes per tile
    hostmap: np.ndarray      # (T*banks*128,) int32 packed row per lane,
    #                          -1 on dead lanes
    gathermap: np.ndarray    # pitch 1: the same array as ``hostmap``
    samp: np.ndarray         # (T, nc, 3, 16, 128) u16: [sample_t hi16,
    #                          sample_t lo16, tile lane | mask << 15, or
    #                          for supercells lane(12) | lb << 12 | m << 15];
    #                          integer data, only bit ops may touch it
    base: np.ndarray         # (T, banks, 3, 128) f32 lane cell base (x,y,z);
    #                          a supercell lane's vertex origin
    rayt: np.ndarray         # (T, 12, 128) f32 ray planes, row ax*2 + half,
    #                          lane ray % 128, axes (ox, oy, oz, dx, dy, dz)
    bank0: np.ndarray        # (T, nc, n_sub) int32 window start bank per
    #                          (chunk, sub-tile), bits 0..13, | ALIGNED
    #                          << 30 (read only by the JAX backward)
    ray_ids: np.ndarray      # (T, 256) int32 global ray id (dead -> 0)
    k_enter: np.ndarray      # (T,) int32 tile window start step
    pixel_ids: np.ndarray    # (T*256,) int32 compose targets per ray
    tile_ids: np.ndarray     # (T, n_sub) int32 compose id per sub-tile
    #                          (pads and overflowing sub-tiles: 1 << 30)
    samples: int             # live sample count

    def to(self, device) -> "TileGroup":
        return dataclasses.replace(self, **{
            f.name: _to_device(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class TiledSchedule:
    groups: tuple            # of TileGroup
    fallback: object         # always None: no windowed fallback yet
    hostmap_all: np.ndarray  # (S,) int32 every group's hostmap, concatenated
    gathermap_all: np.ndarray  # (S,) int32 the bank gather's rows
    gather_plan: object      # GatherPlan | None (an empty schedule)
    total_rays: int
    tiled_samples: int
    full_lattice_samples: int
    fallback_rays: int       # rays whose sub-tiles overflow the slot
    #                          tables (counted as the JAX package counts)
    grid_shape: tuple        # (nz, ny, nx) the cell ids index
    bbox: tuple              # ((min), (max)) the windows and cells assume
    tile_px: int = 16
    table_kind: str = "dense"  # "sparse": lanes name brick-table rows
    pitch: int = 1
    cell_scale: int = 1

    def to(self, device) -> "TiledSchedule":
        """The schedule with every array as a tensor on ``device``."""
        return dataclasses.replace(
            self,
            groups=tuple(g.to(device) for g in self.groups),
            hostmap_all=_to_device(self.hostmap_all, device),
            gathermap_all=_to_device(self.gathermap_all, device),
            gather_plan=(self.gather_plan.to(device)
                         if self.gather_plan is not None else None))

    @property
    def device(self):
        """The device of the arrays, or None while they are numpy."""
        return (self.gathermap_all.device
                if isinstance(self.gathermap_all, torch.Tensor) else None)


# ----------------------------------------------------------------- host side


def build_tiled_schedule_auto(plan: Plan, field, jitter=None,
                              occupancy: bool = False,
                              quantize: bool = False,
                              pitch: int = 1):
    """Build the schedule at the coarsest configuration whose slot tables
    hold the scene, by ``dvren_tpu``'s cascade; returns (schedule, note).

    16 px cell tables first; while more than a tenth of the rays
    overflow, (tile_px, cell_scale) = (16, 2), (8, 1), (8, 2), (4, 1) for
    a dense float32 field, (8, 1), (4, 1) for a 16-bit or sparse one,
    each kept when it overflows fewer rays. ``note`` names the chosen
    configuration ("tiled_subtiled_8px", "tiled_supercell_16px", ...) or
    is None at 16 px cells. The JAX package renders the rays that still
    overflow through the windowed path; this port has none yet, so a
    chosen schedule with overflow rays raises ``NotImplementedError``."""
    sched = build_tiled_schedule(plan, field, jitter=jitter,
                                 occupancy=occupancy, quantize=quantize,
                                 pitch=pitch)
    note = None
    supercell_ok = (not hasattr(field, "bricks")
                    and getattr(field, "packed_dtype", "float32")
                    == "float32")
    cascade = ([(16, 2), (8, 1), (8, 2), (4, 1)] if supercell_ok
               else [(8, 1), (4, 1)])
    for px, scale in cascade:
        if sched.fallback_rays * 10 <= sched.total_rays:
            break
        s_fine = build_tiled_schedule(plan, field, jitter=jitter,
                                      occupancy=occupancy, tile_px=px,
                                      quantize=quantize, pitch=pitch,
                                      cell_scale=scale)
        if s_fine.fallback_rays < sched.fallback_rays:
            sched = s_fine
            note = (f"tiled_subtiled_{px}px" if scale == 1
                    else f"tiled_supercell_{px}px")
    if sched.fallback_rays:
        raise NotImplementedError(
            f"{sched.fallback_rays} of {sched.total_rays} rays overflow the "
            f"slot tables at tile_px={sched.tile_px}, "
            f"cell_scale={sched.cell_scale}: needs {_TODO_FALLBACK}")
    return sched, note


def _tile_rays(plan: Plan, tile_px: int = 16):
    """Global ray ids per 16x16 block, (n_blocks, 256) with -1 past the
    ROI edge, and each block's sub-tile compose ids, (n_blocks, n_sub).

    ``tile_px`` 16: one image tile per block, rays row-major. 8 or 4:
    (16 / tile_px)^2 sub-tiles of tile_px x tile_px pixels per block, rays
    ordered sub-major (sub-tile s row-major, then its pixels row-major),
    so sub-tile s owns block rows s * 16 / n_sub onward; its compose id
    indexes the ceil(roi / tile_px) sub-tile grid, -1 past its edge
    (``dvren_tpu``'s ``_tile_rays``)."""
    roi = plan.roi
    per = 16 // tile_px
    sx_n = -(-roi.width // tile_px)
    sy_n = -(-roi.height // tile_px)
    tx_n = -(-roi.width // TILE_W)
    ty_n = -(-roi.height // TILE_H)
    # axes (ty, tx, sy, sx, iy, ix)
    ys = (np.arange(ty_n)[:, None, None, None, None, None] * TILE_H
          + np.arange(per)[None, None, :, None, None, None] * tile_px
          + np.arange(tile_px)[None, None, None, None, :, None])
    xs = (np.arange(tx_n)[None, :, None, None, None, None] * TILE_W
          + np.arange(per)[None, None, None, :, None, None] * tile_px
          + np.arange(tile_px)[None, None, None, None, None, :])
    ids = np.where((ys < roi.height) & (xs < roi.width),
                   ys * roi.width + xs, -1)
    tiles = ids.reshape(ty_n * tx_n, RAYS_PER_TILE)
    gy = (np.arange(ty_n)[:, None, None, None] * per
          + np.arange(per)[None, None, :, None])
    gx = (np.arange(tx_n)[None, :, None, None] * per
          + np.arange(per)[None, None, None, :])
    sub = np.where((gy < sy_n) & (gx < sx_n), gy * sx_n + gx, -1)
    return tiles, sub.reshape(ty_n * tx_n, per * per)


def _pack_runs_numpy(flat: np.ndarray, umax: int):
    """Per row of sample cell ids: stable sort, give each distinct cell its
    lane in sorted order (the sentinel sorts last and gets none), and list
    the distinct (cell, lane) pairs, at most ``umax`` per row.

    Returns (lidx, lanes_run, ucell, ulane, n_u): the per-sample lane, the
    run's lane count, the cells and lanes (-1 / 0 padded) and their
    number."""
    order = np.argsort(flat, axis=1, kind="stable")
    sc = np.take_along_axis(flat, order, 1)
    new = np.ones(flat.shape, bool)
    new[:, 1:] = sc[:, 1:] != sc[:, :-1]
    rank = np.cumsum(new, axis=1, dtype=np.int32) - 1
    has_sent = sc[:, -1] == _SENTINEL
    lanes_run = (rank[:, -1] + 1 - has_sent).astype(np.int32)
    lidx = np.empty(flat.shape, np.int32)
    np.put_along_axis(lidx, order, rank, 1)

    # stable valid-first partition along the sorted axis
    valid = new & (sc != _SENTINEL)
    ord2 = np.argsort(~valid, axis=1, kind="stable")
    n_u = np.minimum(valid.sum(1), umax).astype(np.int32)
    within = np.arange(umax)[None, :] < n_u[:, None]
    ucell = np.where(within, np.take_along_axis(sc, ord2[:, :umax], 1), -1)
    ulane = np.where(within, np.take_along_axis(rank, ord2[:, :umax], 1),
                     0).astype(np.int32)
    return lidx, lanes_run, ucell, ulane, n_u


def _sparse_rows_for_cells(cells: np.ndarray, occ: np.ndarray,
                           grid_shape) -> np.ndarray:
    """Full-pitch base-cell ids -> brick-table rows (slot * BRICK^3 +
    brick-local cell), resolved on the host: the sparse field's two-level
    indirection costs nothing at render time."""
    nz, ny, nx = grid_shape
    iz = cells // (ny * nx)
    rem = cells % (ny * nx)
    iy = rem // nx
    ix = rem % nx
    slot = occ[iz // BRICK, iy // BRICK, ix // BRICK].astype(np.int64)
    local = ((iz % BRICK) * BRICK + (iy % BRICK)) * BRICK + (ix % BRICK)
    return slot * (BRICK ** 3) + local


def _check_slice(field, pitch, occupancy, quantize, uniform_shape,
                 all_tiles, bank_aligned):
    if pitch != 1:
        raise NotImplementedError(_TODO_PITCH2)
    if occupancy:
        raise NotImplementedError(_TODO_OCCUPANCY)
    if quantize or uniform_shape is not None or all_tiles or bank_aligned:
        raise NotImplementedError(_TODO_MULTIVIEW)
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "tiled rendering requires an OOB_ZERO field")
    check(getattr(field, "interp", InterpMode.LINEAR) == InterpMode.LINEAR,
          "tiled rendering precomputes trilinear fractions; NEAREST fields "
          "must use the windowed/full paths")


def build_tiled_schedule(plan: Plan, field, jitter=None,
                         occupancy: bool = False, tile_px: int = 16,
                         quantize: bool = False, pitch: int = 1,
                         cell_scale: int = 1,
                         uniform_shape: tuple | None = None,
                         all_tiles: bool = False,
                         bank_aligned: bool = False) -> TiledSchedule:
    """Build the tile-table schedule for (plan, field bbox + resolution),
    as numpy arrays (move it with :meth:`TiledSchedule.to`).

    ``jitter``: the (N, K) host table of a stratified plan; built from the
    plan when omitted. The schedule is valid for any field with the same
    bbox and grid resolution (and, for a sparse field, occupancy). A
    field with a ``schedule_grid_shape`` (the hash grid path's virtual
    cell grid) schedules over that grid instead of ``sigma``'s; a sparse
    brick field over its ``grid_shape``, with lanes resolved to brick rows
    through its occupancy (``table_kind="sparse"``).

    ``tile_px`` 16, 8 or 4: each 16x16 block holds (16 / tile_px)^2
    sub-tiles with their own bank windows, which divides the cells one
    window must hold. ``cell_scale`` 2: one slot per 2x2x2 supercell of a
    dense float32 grid, whose lanes index the 108-column table of
    :func:`~dvren_tpu_torch.ops.grid.build_supercell_stencil` (pitch is
    then 1, as in the JAX package). A sub-tile with a chunk of more than
    256 slots overflows: its live rays are counted in ``fallback_rays``
    and its pixels left out; a supercell tile wider than 31 banks (the
    12-bit lane) overflows whole."""
    check(tile_px in (4, 8, 16), "tile_px must be 4, 8 or 16")
    check(cell_scale in (1, 2), "cell_scale must be 1 or 2")
    sparse = hasattr(field, "bricks")
    if cell_scale == 2:
        check(not sparse,
              "cell_scale=2 (supercell tables) supports dense grids only")
        check(getattr(field, "packed_dtype", "float32") == "float32",
              "cell_scale=2 requires float32 tables")
        pitch = 1
    _check_slice(field, pitch, occupancy, quantize, uniform_shape, all_tiles,
                 bank_aligned)
    bbox_min = tuple(float(v) for v in field.bbox_min)
    bbox_max = tuple(float(v) for v in field.bbox_max)
    if sparse:
        grid = field.grid_shape
        occ_host = field.occupancy.cpu().numpy()
    else:
        grid = getattr(field, "schedule_grid_shape", None)
        if grid is None:
            grid = field.sigma.shape[:3]
    nz, ny, nx = (int(v) for v in grid)
    check(min(nx, ny, nz) >= 2, "tiled rendering requires grid dims >= 2")
    n_sub = (16 // tile_px) ** 2

    n = plan.ray_count
    dt = np.float32(plan.sampling.dt)
    t_near = np.float32(plan.t_near)
    t_far = np.float32(plan.t_far)
    k_max = plan.sampling.max_steps

    o, d = windowed_mod._host_rays(plan)
    k_enter_ray, k_count_ray = windowed_mod._windows(plan, bbox_min, bbox_max)
    if jitter is None:
        jitter = plan_jitter_table(plan)
    if jitter is not None:
        jitter = np.asarray(jitter, np.float32)

    tiles, sub_tile_ids = _tile_rays(plan, tile_px)    # (n_tiles, 256)
    safe_ids = np.maximum(tiles, 0)
    ray_live = (tiles >= 0) & (k_count_ray[safe_ids] > 0)

    ke = np.where(ray_live, k_enter_ray[safe_ids], np.iinfo(np.int32).max)
    kx = np.where(ray_live, k_enter_ray[safe_ids] + k_count_ray[safe_ids], 0)
    tile_live = ray_live.any(axis=1)
    tile_ke = np.where(tile_live, ke.min(axis=1), 0).astype(np.int64)
    tile_kx = kx.max(axis=1)
    budget = np.maximum(tile_kx - tile_ke, 0)
    budget = np.minimum(-(-budget // CHUNK) * CHUNK, -(-k_max // CHUNK) * CHUNK)
    n_chunks_tile = (budget // CHUNK).astype(np.int64)

    roi = plan.roi
    groups = []
    host_rows: list[np.ndarray] = []
    fallback: list[np.ndarray] = []
    tiled_samples = 0
    pad_pid_base = plan.width * plan.height
    inv_ext = [np.float32(1.0 / (bbox_max[i] - bbox_min[i]))
               if bbox_max[i] != bbox_min[i] else np.float32(0.0)
               for i in range(3)]
    nudge = np.nextafter(t_far, t_near, dtype=np.float32)
    sub_cols = (16 // n_sub) * 128                  # samples per sub-tile run
    umax = min(sub_cols, 2 * MAX_CELLS + 1)

    for nc in sorted(set(n_chunks_tile[tile_live & (n_chunks_tile > 0)])):
        sel = np.nonzero(tile_live & (n_chunks_tile == nc))[0]
        nc = int(nc)
        t_cnt = sel.size
        k_steps = nc * CHUNK
        runs = t_cnt * nc * n_sub

        ids = tiles[sel]                              # (T, 256)
        live_r = ray_live[sel]
        safe = np.maximum(ids, 0)
        ot = o[safe].astype(np.float32)               # (T, 256, 3)
        dtn = d[safe].astype(np.float32)
        ke_t = tile_ke[sel].astype(np.int64)          # (T,)

        # The sample lattice of every tile, in the same float32 steps as
        # the JAX package's numpy builder.
        k = (ke_t[:, None, None]
             + np.arange(k_steps, dtype=np.int64)[None, None, :])
        k = np.broadcast_to(k, (t_cnt, RAYS_PER_TILE, k_steps))
        base_t = t_near + k.astype(np.float32) * dt
        live = (base_t < t_far) & (k < k_max) & live_r[:, :, None]
        if jitter is not None:
            rows = np.minimum(safe, n - 1)
            cols = np.minimum(k, jitter.shape[1] - 1)
            jit = jitter[rows[:, :, None], cols]
        else:
            jit = np.float32(0.5)
        sample_t = np.asarray(base_t + jit * dt, np.float32)
        sample_t = np.where(sample_t >= t_far, nudge, sample_t)

        def _axis(ax, npts):
            p = ot[:, :, ax:ax + 1] + dtn[:, :, ax:ax + 1] * sample_t
            local = (p - np.float32(bbox_min[ax])) * inv_ext[ax]
            inside = (local >= 0.0) & (local <= 1.0)
            f = local * np.float32(npts - 1)
            return inside, np.clip(np.floor(f), 0, npts - 2).astype(np.int64)

        in_x, ix = _axis(0, nx)
        in_y, iy = _axis(1, ny)
        in_z, iz = _axis(2, nz)
        m = in_x & in_y & in_z & live
        if cell_scale == 2:
            # the supercell's row, and the sample's cell in it
            # (lb = lx + 2 ly + 4 lz)
            cell = (((iz >> 1) * (ny // 2) + (iy >> 1)) * (nx // 2)
                    + (ix >> 1))
            lb = np.where(m, (ix & 1) + 2 * (iy & 1) + 4 * (iz & 1), 0)
        else:
            cell = (iz * ny + iy) * nx + ix           # full-pitch table row

        def to_lanes(a):
            # (T, 256, K) -> (T, nc, 16, 128): ray = row * 16 + lane // 8
            a = a.reshape(t_cnt, 16, 16, nc, CHUNK)
            a = a.transpose(0, 3, 1, 2, 4)
            return a.reshape(t_cnt, nc, 16, 128)

        cell_l = to_lanes(np.where(m, cell, _SENTINEL))
        m_l = to_lanes(m.astype(np.float32))
        st_l = to_lanes(np.broadcast_to(
            sample_t, (t_cnt, RAYS_PER_TILE, k_steps)))
        lidx, lanes_run, ucell, ulane, n_u = _pack_runs_numpy(
            cell_l.reshape(runs, sub_cols), umax)
        lb_l = (to_lanes(lb).reshape(runs, sub_cols).astype(np.int32)
                if cell_scale == 2 else None)

        rayt_all = np.stack(
            [ot[:, :, i].reshape(t_cnt, 2, 128) for i in range(3)]
            + [dtn[:, :, i].reshape(t_cnt, 2, 128) for i in range(3)],
            axis=1).astype(np.float32).reshape(t_cnt, 12, 128)

        # A sub-tile with a chunk of more than 256 cells overflows: its
        # live rays would need the windowed fallback, its samples are
        # masked and its runs emptied; a tile whose sub-tiles all overflow
        # is left out.
        lanes3 = lanes_run.reshape(t_cnt, nc, n_sub)
        sub_bad = (lanes3 > 2 * MAX_CELLS).any(axis=1)   # (T, n_sub)
        overflow = sub_bad.all(axis=1)
        if sub_bad.any():
            fb = ids.reshape(t_cnt, n_sub, -1)[sub_bad][
                live_r.reshape(t_cnt, n_sub, -1)[sub_bad]]
            if fb.size:
                fallback.append(fb)
            lanes3 = np.where(sub_bad[:, None, :], 0, lanes3)
            m_l = (m_l.reshape(t_cnt, nc, n_sub, sub_cols)
                   * ~sub_bad[:, None, :, None]).reshape(t_cnt, nc, 16, 128)
            n_u = np.where(np.broadcast_to(
                sub_bad[:, None, :], (t_cnt, nc, n_sub)).reshape(-1), 0, n_u)

        # Dense bank packing: each (chunk, sub-tile) run lands at the next
        # free lane; runs of more than 128 cells start on a bank boundary.
        # Empty runs anchor at lane 0 (their samples are masked but must
        # index a valid lane).
        lanes_f = lanes3.reshape(t_cnt, nc * n_sub).astype(np.int64)
        offs = np.zeros((t_cnt, nc * n_sub), np.int64)
        cur = np.zeros(t_cnt, np.int64)
        for r in range(nc * n_sub):
            n_c = lanes_f[:, r]
            cur = np.where(n_c > MAX_CELLS, -(-cur // MAX_CELLS) * MAX_CELLS,
                           cur)
            offs[:, r] = np.where(n_c > 0, cur, 0)
            cur += n_c
        off = np.where(overflow[:, None, None], 0,
                       offs.reshape(t_cnt, nc, n_sub))
        nb_tile = np.where(overflow, 0, np.maximum(-(-cur // MAX_CELLS), 1))
        if cell_scale == 2:
            # the supercell word has 12 lane bits: <= 31 banks per tile;
            # a wider tile overflows whole
            too_wide = (~overflow) & (nb_tile > 31)
            if too_wide.any():
                fb = ids[too_wide][live_r[too_wide]]
                if fb.size:
                    fallback.append(fb)
                overflow = overflow | too_wide
                nb_tile = np.where(too_wide, 0, nb_tile)

        for nb in sorted(set(nb_tile[~overflow].tolist())):
            keep = (~overflow) & (nb_tile == nb)
            nb = int(nb)
            lanes = nb * MAX_CELLS
            t_kept = int(keep.sum())
            rowsel = np.repeat(keep, nc * n_sub)
            off_k = off[keep].reshape(-1)            # (t_kept * nc * n_sub,)

            # Dead lanes (bank rounding, pad tiles, empty-run anchors) are
            # -1; the device gather reads row 0 for them.
            hostmap = np.full((t_kept, lanes), -1, np.int64)
            n_u_k = n_u[rowsel]
            ucell_k, ulane_k = ucell[rowsel], ulane[rowsel]
            rws, cls = np.nonzero(
                np.arange(ucell.shape[1])[None, :] < n_u_k[:, None])
            hostmap[rws // (nc * n_sub), off_k[rws] + ulane_k[rws, cls]] = \
                ucell_k[rws, cls]

            # Tile-local lanes; masked samples point at their run's start.
            rank_s = lidx.reshape(t_cnt, nc, n_sub, sub_cols)[keep].astype(
                np.int64)
            m_k4 = m_l.reshape(t_cnt, nc, n_sub, sub_cols)[keep] > 0
            off_bc = off[keep][:, :, :, None]
            nuq_bc = lanes3[keep][:, :, :, None]
            lidx_local = np.where(m_k4, off_bc + np.minimum(
                rank_s, np.maximum(nuq_bc - 1, 0)),
                off_bc).astype(np.int32).reshape(t_kept, nc, 16, 128)
            m_k = m_k4.reshape(t_kept, nc, 16, 128).astype(np.int32)

            if cell_scale == 2:
                check(nb <= 31,
                      "supercell bank space exceeds the 12-bit lane id")
                lb_k = lb_l.reshape(t_cnt, nc, n_sub, sub_cols)[keep].reshape(
                    t_kept, nc, 16, 128)
                packed_bits = lidx_local | (lb_k << 12) | (m_k << 15)
            else:
                check(nb <= 255, "bank space exceeds the 15-bit lane id")
                packed_bits = lidx_local | (m_k << 15)
            st_bits = np.ascontiguousarray(st_l[keep]).view(np.uint32)
            samp = np.stack(
                [(st_bits >> 16).astype(np.uint16),
                 (st_bits & np.uint32(0xFFFF)).astype(np.uint16),
                 packed_bits.astype(np.uint16)],
                axis=2)                               # (T, nc, 3, 16, 128)

            # Per-lane cell base coordinates: the clipped floor indices,
            # recovered from the lane's cell id (dead lanes: cell 0); a
            # supercell lane holds its vertex origin, 2 s per axis.
            hm_c = np.maximum(hostmap, 0)
            if cell_scale == 2:
                snx, sny = nx // 2, ny // 2
                iz_u = hm_c // (sny * snx)
                rem_u = hm_c % (sny * snx)
                base = np.stack([2 * (rem_u % snx), 2 * (rem_u // snx),
                                 2 * iz_u], axis=1).astype(np.float32)
            else:
                iz_u = hm_c // (ny * nx)
                rem_u = hm_c % (ny * nx)
                base = np.stack([(rem_u % nx), (rem_u // nx), iz_u],
                                axis=1).astype(np.float32)  # (T, 3, lanes)
            base = base.reshape(t_kept, 3, nb, MAX_CELLS).transpose(
                0, 2, 1, 3)                               # (T, nb, 3, 128)
            rayt = rayt_all[keep]
            # ALIGNED bit (30): the run fits bank b0 alone. Only the JAX
            # backward reads it; the kernels here mask it off.
            n_keep = lanes3[keep]
            fits = (n_keep > 0) & (off[keep] % MAX_CELLS + n_keep
                                   <= MAX_CELLS)
            bank0 = ((off[keep] // MAX_CELLS)
                     | (fits.astype(np.int64) << 30)).astype(np.int32)
            #        (T, nc, n_sub): the kernels' flat (t*nc + c)*subs + s

            ids_k = ids[keep]
            ray_ids_k = np.maximum(ids_k, 0).astype(np.int32)
            live_k = live_r[keep]
            lx = np.where(ids_k >= 0, ids_k % roi.width, 0)
            ly = np.where(ids_k >= 0, ids_k // roi.width, 0)
            pids = (roi.y + ly) * plan.width + (roi.x + lx)
            n_bad = int((~live_k).sum())
            pids = np.where(
                live_k, pids,
                pad_pid_base + np.cumsum(~live_k.reshape(-1)).reshape(
                    live_k.shape) - 1)
            pad_pid_base += n_bad

            # Pad the group to a multiple of 8 tiles with dead tiles:
            # m == 0 everywhere, lane 0, packed row 0, throwaway pixels.
            t_pad = -(-t_kept // 8) * 8
            if sparse:
                # lanes name brick rows; ``base`` keeps the cell ids
                uniq_r = np.where(
                    hostmap >= 0,
                    _sparse_rows_for_cells(hm_c, occ_host, (nz, ny, nx)),
                    -1).astype(np.int32)
            else:
                uniq_r = hostmap.astype(np.int32)     # (T, lanes)
            ke_k = ke_t[keep].astype(np.int32)
            # compose targets: overflowing or ROI-dead sub-tiles drop
            tile_ids_k = np.where(
                sub_bad[keep] | (sub_tile_ids[sel][keep] < 0), _DROP_TILE,
                sub_tile_ids[sel][keep]).astype(np.int32)   # (T, n_sub)
            pids = pids.reshape(t_kept, RAYS_PER_TILE)
            if t_pad != t_kept:
                extra = t_pad - t_kept

                def pad(a, fill=0):
                    return np.concatenate(
                        [a, np.full((extra,) + a.shape[1:], fill, a.dtype)])

                samp, base, rayt = pad(samp), pad(base), pad(rayt)
                uniq_r = pad(uniq_r, -1)
                bank0, ray_ids_k, ke_k = pad(bank0), pad(ray_ids_k), pad(ke_k)
                tile_ids_k = pad(tile_ids_k, _DROP_TILE)
                pad_ids = (pad_pid_base + np.arange(
                    extra * RAYS_PER_TILE)).reshape(extra, RAYS_PER_TILE)
                pad_pid_base += extra * RAYS_PER_TILE
                pids = np.concatenate([pids, pad_ids.astype(pids.dtype)])

            n_samples = int(m_l[keep].sum())
            tiled_samples += n_samples
            hm = uniq_r.reshape(-1)
            host_rows.append(hm)
            groups.append(TileGroup(
                n_chunks=nc, n_tiles=t_pad, banks=nb,
                hostmap=hm, gathermap=hm, samp=samp, base=base, rayt=rayt,
                bank0=bank0, ray_ids=ray_ids_k, k_enter=ke_k,
                pixel_ids=pids.reshape(-1).astype(np.int32),
                tile_ids=tile_ids_k, samples=n_samples))

    hostmap_all = (np.concatenate(host_rows) if host_rows
                   else np.zeros(0, np.int32))
    if sparse:
        n_rows = int(field.bricks.shape[0]) * BRICK ** 3
    elif cell_scale == 2:
        n_rows = supercell_rows((nz, ny, nx))
    else:
        n_rows = fullpitch_rows((nz, ny, nx))
    return TiledSchedule(
        groups=tuple(groups), fallback=None,
        hostmap_all=hostmap_all, gathermap_all=hostmap_all,
        gather_plan=build_gather_plan(hostmap_all, n_rows),
        total_rays=n, tiled_samples=tiled_samples,
        full_lattice_samples=n * k_max,
        fallback_rays=int(sum(f.size for f in fallback)),
        grid_shape=(nz, ny, nx), bbox=(bbox_min, bbox_max), tile_px=tile_px,
        table_kind="sparse" if sparse else "dense", cell_scale=cell_scale)


# --------------------------------------------------------------- device side


def _gather_bank_tables(table: torch.Tensor, gathermap_all: torch.Tensor,
                        group_shapes) -> tuple:
    """(R, w) packed table -> per-group float32 bank blocks (T, NB, w,
    128): w = 32 for a dense grid or a brick table, the hash grid's C =
    L*8*F columns for a hash field (``dvren_tpu``'s ``_gather_banks_f32``;
    its transpose is :func:`slot_rows_to_table`). A 16-bit table is
    widened after the gather, as ``dvren_tpu``'s ``_group_tables`` does.

    Dead lanes (-1) read row 0, as the JAX gather's ``mode="clip"``
    does; torch indexing would wrap -1 to the last row. (The JAX 16-bit
    route wraps; dead lanes carry masked samples only, so the render is
    the same.)"""
    w = int(table.shape[1])
    rows = torch.index_select(table, 0, gathermap_all.clamp(min=0))
    if rows.dtype != torch.float32:
        rows = rows.float()
    banks = rows.reshape(-1, MAX_CELLS, w).transpose(1, 2).contiguous()
    out, off = [], 0
    for t_cnt, nb in group_shapes:
        out.append(banks[off:off + t_cnt * nb].reshape(
            t_cnt, nb, w, MAX_CELLS))
        off += t_cnt * nb
    return tuple(out)


def raw_to_subtiles(raw: torch.Tensor, tile_px: int) -> torch.Tensor:
    """Raw heads (T, 5, 16, 16) -> per sub-tile blocks (T*n_sub, 5, px, px)."""
    n_sub = (16 // tile_px) ** 2
    raw = raw.reshape(-1, 5, n_sub, tile_px * tile_px)
    return raw.permute(0, 2, 1, 3).reshape(-1, 5, tile_px, tile_px)


def tiles5_to_planes(plan: Plan, tiles5: torch.Tensor, tile_px: int):
    """Per-tile heads (n_tiles, 5, px, px) in ROI tile order -> frame
    planes (image (H, W, 3), transmittance, opacity, depth), with the
    background outside the ROI."""
    roi = plan.roi
    sx_n = -(-roi.width // tile_px)
    sy_n = -(-roi.height // tile_px)
    a = tiles5.reshape(sy_n, sx_n, 5, tile_px, tile_px)
    a = a.permute(2, 0, 3, 1, 4).reshape(5, sy_n * tile_px, sx_n * tile_px)
    a = a[:, :roi.height, :roi.width]
    (r, g, b), t_final, opacity, depth = fused_tiles.finalize_heads(
        plan, a, axis=0)

    def place(x, fill):
        if (roi.x, roi.y, roi.width, roi.height) == (0, 0, plan.width,
                                                     plan.height):
            return x
        full = torch.full((plan.height, plan.width), float(fill),
                          dtype=x.dtype, device=x.device)
        full[roi.y:roi.y + roi.height, roi.x:roi.x + roi.width] = x
        return full

    image = torch.stack([place(r, 0.0), place(g, 0.0), place(b, 0.0)],
                        dim=-1)
    return (image, place(t_final, 1.0), place(opacity, 0.0),
            place(depth, float(plan.t_far)))


class _PlaceTiles(torch.autograd.Function):
    """Place rendered tiles at their ROI tile index: ``out[ids[i]] =
    raw[i]``, with ids outside [0, n_tiles) dropped (the pad tiles). The
    ids of kept tiles are distinct, so both directions are gathers:
    forward through the inverse map, backward through ``ids``. (Traced
    indexing would put an accumulating ``index_put_`` in the backward.)"""

    @staticmethod
    def forward(ctx, raw, ids, n_tiles: int):
        dst = torch.where((ids >= 0) & (ids < n_tiles), ids,
                          torch.full_like(ids, n_tiles))
        n = raw.shape[0]
        # src[tile] = the raw tile placed there, or the zero row n; the
        # dropped tiles land in src[n_tiles], which is never read (storing
        # a Python scalar there would be a host copy that waits for the
        # stream)
        src = torch.full((n_tiles + 1,), n, dtype=torch.long,
                         device=raw.device)
        src[dst] = torch.arange(n, device=raw.device)
        ctx.save_for_backward(dst)
        padded = torch.cat([raw, raw.new_zeros((1,) + raw.shape[1:])])
        return torch.index_select(padded, 0, src[:n_tiles])

    @staticmethod
    def backward(ctx, grad):
        (dst,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        return torch.index_select(padded, 0, dst), None, None


def _compose_tiles(plan: Plan, raws, tile_ids, fallback_parts=(),
                   tile_px: int = 16, device=None) -> ImagePlanes:
    """Place each (16, 16) output block's sub-tiles at their image
    regions. Sub-tiles with an id outside the ROI's tile_px grid (the
    sentinel 1 << 30 of pads and overflowing sub-tiles) are dropped, as
    the JAX scatter's ``mode="drop"`` does. Rays that no tile renders
    keep the background (T = 1, depth = t_far). Differentiable in
    ``raws``. ``device``: where the planes of an empty schedule (no
    ``raws``) are built."""
    if fallback_parts:
        raise NotImplementedError(_TODO_FALLBACK)
    roi = plan.roi
    n_tiles = (-(-roi.width // tile_px)) * (-(-roi.height // tile_px))
    if raws:
        raw = raw_to_subtiles(torch.cat(raws), tile_px)
        ids = torch.cat([t.reshape(-1) for t in tile_ids]).long()
        tiles5 = _PlaceTiles.apply(raw, ids, n_tiles)
    else:
        tiles5 = torch.zeros((n_tiles, 5, tile_px, tile_px),
                             dtype=torch.float32, device=device)
    image, trans, opac, dep = tiles5_to_planes(plan, tiles5, tile_px)
    return ImagePlanes(image=image, transmittance=trans, opacity=opac,
                       depth=dep,
                       hitmask=windowed_mod.roi_hitmask(plan, image.device))


class _GroupsetFromParams(torch.autograd.Function):
    """Dense-grid params -> every tile group's raw K1 output, as one
    autograd node: the counterpart of ``dvren_tpu``'s
    ``_groupset_from_params``.

    Forward: the packed table (K3), the bank gather, K1 per group.
    Backward: K2 per group (slot rows, and d(rayt) when ``cam``), one
    ``torch.cat`` of the slot rows, :func:`slot_rows_to_table`, then K4.
    Returns (None, d_sigma, d_color, *d_rayt per group). Autograd
    never records the table gather: its backward would be ``index_add_``.
    ``static`` = (schedule, per-group TileParams, use_kernel, cam); on CPU
    tensors every kernel step runs its plain twin."""

    @staticmethod
    def forward(ctx, static, sigma, color, *rayts):
        schedule, params, use_kernel, cam = static
        if use_kernel:
            table = packed_transpose.build_rows(sigma, color)
            forward = fused_tiles.tile_forward
        else:
            table = packed_transpose.build_rows_plain(sigma, color)
            forward = fused_tiles.tile_forward_plain
        tabs = _gather_bank_tables(
            table, schedule.gathermap_all,
            [(g.n_tiles, g.banks) for g in schedule.groups])
        raws = tuple(
            forward(tabs[gi], g.samp, g.base, rayts[gi], g.k_enter,
                    g.bank0.reshape(-1), params[gi])
            for gi, g in enumerate(schedule.groups))
        ctx.static = static
        ctx.tabs = tabs
        ctx.grid_shape = tuple(sigma.shape)
        ctx.save_for_backward(*rayts)
        return raws

    @staticmethod
    def backward(ctx, *g_raws):
        schedule, params, use_kernel, cam = ctx.static
        rayts = ctx.saved_tensors
        backward = (fused_tiles.tile_backward if use_kernel
                    else fused_tiles.tile_backward_plain)
        want_grid = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        rows, d_rayts = [], []
        for gi, g in enumerate(schedule.groups):
            d_rows, d_rayt = backward(
                ctx.tabs[gi], g.samp, g.base, rayts[gi], g.k_enter,
                g.bank0.reshape(-1), g_raws[gi].contiguous(), params[gi],
                cam)
            rows.append(d_rows.reshape(-1, NCH))
            d_rayts.append(d_rayt)
        d_sigma = d_color = None
        if want_grid:
            table_grad = slot_rows_to_table(
                torch.cat(rows), schedule.gather_plan,
                fullpitch_rows(ctx.grid_shape))
            unpack = (packed_transpose.table_grad_to_params if use_kernel
                      else packed_transpose.table_grad_to_params_plain)
            d_sigma, d_color = unpack(table_grad, ctx.grid_shape)
        return (None, d_sigma, d_color, *d_rayts)


class _Table16FromParams(torch.autograd.Function):
    """Dense-grid params -> the (R, 32) 16-bit packed table: K5a forward,
    K5b backward (``dvren_tpu``'s ``_build_fullpitch`` custom VJP on a
    16-bit dtype). ``static`` = (dtype, use_kernel); on CPU tensors both
    run their plain twins."""

    @staticmethod
    def forward(ctx, static, sigma, color):
        dtype, use_kernel = static
        build = (packed_transpose.build_rows16 if use_kernel
                 else packed_transpose.build_rows16_plain)
        ctx.static = static
        ctx.grid_shape = tuple(sigma.shape)
        return build(sigma, color, dtype)

    @staticmethod
    def backward(ctx, g_table):
        _, use_kernel = ctx.static
        unpack = (packed_transpose.table16_grad_to_params if use_kernel
                  else packed_transpose.table16_grad_to_params_plain)
        d_sigma, d_color = unpack(g_table.contiguous(), ctx.grid_shape)
        return None, d_sigma, d_color


class _GroupsetFromTable(torch.autograd.Function):
    """Any (R, C) table (float32, bfloat16 or float16) -> every tile
    group's raw K1 output, as one autograd node: the flat-table route of
    ``dvren_tpu``'s ``render_tiled`` (a 16-bit dense table, a sparse
    field's bricks, or the (R_s, 108) supercell table).

    Forward: the bank gather, widened to f32 after it, then K1 per group.
    Backward: K2 per group (f32 slot rows, and d(rayt) when ``cam``).
    For a 16-bit table every slot row is rounded to the table's dtype, as
    the JAX cotangent of the widening cast is; the rows of each cell are
    then summed in f32 in the gather plan's fixed order
    (:func:`slot_rows_to_table`) and the sums rounded once to the table's
    dtype. (JAX's scatter-add adds in the 16-bit dtype, in scatter
    order.) Returns (None, d_table in the table's dtype, *d_rayt per
    group). ``static`` = (schedule, per-group TileParams, use_kernel,
    cam)."""

    @staticmethod
    def forward(ctx, static, table, *rayts):
        schedule, params, use_kernel, cam = static
        forward = (fused_tiles.tile_forward if use_kernel
                   else fused_tiles.tile_forward_plain)
        tabs = _gather_bank_tables(
            table, schedule.gathermap_all,
            [(g.n_tiles, g.banks) for g in schedule.groups])
        raws = tuple(
            forward(tabs[gi], g.samp, g.base, rayts[gi], g.k_enter,
                    g.bank0.reshape(-1), params[gi])
            for gi, g in enumerate(schedule.groups))
        ctx.static = static
        ctx.tabs = tabs
        ctx.table_meta = (int(table.shape[0]), table.dtype)
        ctx.save_for_backward(*rayts)
        return raws

    @staticmethod
    def backward(ctx, *g_raws):
        schedule, params, use_kernel, cam = ctx.static
        n_rows, dtype = ctx.table_meta
        rayts = ctx.saved_tensors
        backward = (fused_tiles.tile_backward if use_kernel
                    else fused_tiles.tile_backward_plain)
        rows, d_rayts = [], []
        for gi, g in enumerate(schedule.groups):
            d_rows, d_rayt = backward(
                ctx.tabs[gi], g.samp, g.base, rayts[gi], g.k_enter,
                g.bank0.reshape(-1), g_raws[gi].contiguous(), params[gi],
                cam)
            rows.append(d_rows.reshape(-1, d_rows.shape[-1]))
            d_rayts.append(d_rayt)
        d_table = None
        if ctx.needs_input_grad[1]:
            d_table = slot_rows_to_table_as(torch.cat(rows),
                                            schedule.gather_plan, n_rows,
                                            dtype)
        return (None, d_table, *d_rayts)


def slot_rows_to_table_as(rows: torch.Tensor, plan, n_rows: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """f32 slot rows (S, w) -> the (n_rows, w) gradient of a table in
    ``dtype``: each row rounded to ``dtype`` (the cotangent of the
    gather's widening cast), summed per cell in f32 through the gather
    plan, and the sums rounded once to ``dtype``. The transpose of
    ``dvren_tpu``'s ``jnp.take(table, hostmap).astype(float32)``, whose
    scatter-add adds in ``dtype``: equal to it where a cell has one slot,
    within ``dtype``'s roundoff times the slot count elsewhere."""
    if dtype != torch.float32:
        rows = rows.to(dtype).float()
    return slot_rows_to_table(rows, plan, n_rows).to(dtype)


def _traced_rayts(plan: Plan, schedule: TiledSchedule, k, c2w) -> list:
    """Each group's (T, 12, 128) ray planes rebuilt from the camera
    tensors ``k`` / ``c2w`` (autograd records them), for the rays the
    schedule baked in: dead and pad lanes carry ray 0 there too."""
    ids = torch.cat([g.ray_ids.reshape(-1) for g in schedule.groups])
    rays = generate_rays(plan, k=k, c2w=c2w, ids=ids)
    out, off = [], 0
    for g in schedule.groups:
        nt = g.n_tiles
        n_r = nt * RAYS_PER_TILE
        o = rays.origins[off:off + n_r]
        d = rays.directions[off:off + n_r]
        off += n_r
        out.append(torch.stack(
            [o[:, i].reshape(nt, 2, 128) for i in range(3)]
            + [d[:, i].reshape(nt, 2, 128) for i in range(3)],
            dim=1).reshape(nt, 12, 128))
    return out


def render_tiled(plan: Plan, field, schedule: TiledSchedule,
                 use_kernel: bool = True, k=None, c2w=None) -> ImagePlanes:
    """Tile-table render of a dense or sparse brick field, differentiable
    in the field's ``sigma`` and ``color`` (or ``bricks``) and, through
    ``k`` (3, 3) / ``c2w`` (3, 4), in the camera at the schedule's
    camera.

    Routes: a dense float32 field on a cell schedule takes
    :class:`_GroupsetFromParams` (K3, K1, K2, K4); on a supercell schedule
    the 108-column table of :func:`build_supercell_stencil` (autograd
    gives its adjoint) into :class:`_GroupsetFromTable` (K1, K2); a dense
    16-bit field :class:`_Table16FromParams` (K5a, K5b) into
    :class:`_GroupsetFromTable`; a sparse field its bricks, flat, into
    :class:`_GroupsetFromTable`. K1 and K2 run in the schedule's form:
    (16 // tile_px) ** 2 sub-tiles per block, the supercell stencil at
    cell_scale 2.

    The schedule must be on the field's device (:meth:`TiledSchedule.to`).
    ``use_kernel=False`` runs the plain PyTorch twins of the kernels on
    that device: the reference the kernels are held to. With ``k`` or
    ``c2w`` the ray planes are rebuilt from those tensors and the backward
    emits their adjoint; the cells, slots and mask stay the schedule's, so
    a camera far from the schedule's needs a new schedule."""
    check(tuple(float(v) for v in field.bbox_min) == tuple(schedule.bbox[0])
          and tuple(float(v) for v in field.bbox_max)
          == tuple(schedule.bbox[1]),
          "schedule was built for a different field bbox (cell ids and "
          "fraction constants depend on it)")
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "tiled rendering requires an OOB_ZERO field")
    sparse = hasattr(field, "bricks")
    kind = "sparse" if sparse else "dense"
    check(schedule.table_kind == kind,
          f"schedule was built for a {schedule.table_kind} field, this one "
          f"is {kind}")
    shape = field.grid_shape if sparse else field.sigma.shape[:3]
    check(tuple(int(v) for v in shape) == tuple(schedule.grid_shape),
          "schedule was built for a different grid resolution")
    packed_dtype = getattr(field, "packed_dtype", "float32")
    check(schedule.cell_scale == 1 or packed_dtype == "float32",
          "supercell schedules need float32 tables")
    if schedule.fallback_rays:
        raise NotImplementedError(
            f"{schedule.fallback_rays} rays need {_TODO_FALLBACK}")
    device = field.bricks.device if sparse else field.sigma.device
    check(schedule.device == device,
          f"schedule is on {schedule.device}, the field on {device}: "
          f"move it with schedule.to(device)")

    geom = (schedule.bbox[0], schedule.bbox[1], schedule.grid_shape)
    subs = (16 // schedule.tile_px) ** 2
    stencil = "super" if schedule.cell_scale == 2 else "cell"
    params = tuple(fused_tiles.tile_op_params(plan, geom, g.banks, g.n_chunks,
                                              subs, stencil)
                   for g in schedule.groups)
    cam = k is not None or c2w is not None
    raws = []
    if schedule.groups:
        rayts = (_traced_rayts(plan, schedule, k, c2w) if cam
                 else [g.rayt for g in schedule.groups])
        static = (schedule, params, use_kernel, cam)
        if sparse:
            raws = _GroupsetFromTable.apply(
                static, field.bricks.reshape(-1, NCH), *rayts)
        elif stencil == "super":
            raws = _GroupsetFromTable.apply(
                static, build_supercell_stencil(field.sigma, field.color),
                *rayts)
        elif packed_dtype == "float32":
            raws = _GroupsetFromParams.apply(static, field.sigma,
                                             field.color, *rayts)
        else:
            table = _Table16FromParams.apply(
                (table_dtype(packed_dtype), use_kernel), field.sigma,
                field.color)
            raws = _GroupsetFromTable.apply(static, table, *rayts)
        raws = list(raws)
    return _compose_tiles(plan, raws, [g.tile_ids for g in schedule.groups],
                          tile_px=schedule.tile_px, device=device)
