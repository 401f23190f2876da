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
block from it, renders every tile group in one K1 launch
(:mod:`dvren_tpu_torch.ops.fused_tiles`, over the schedule's flat arrays
``TiledSchedule.tiles`` and their per-tile descriptor) and places the
(16, 16) output tiles into the image.

The backward (:class:`_GroupsetFromParams`, what autograd runs through
:func:`render_tiled`) runs one K2 launch, which emits each tile's table
gradient as f32 slot rows (and the ray-plane adjoint for camera
gradients), sums the rows of every cell through the schedule's
:class:`~dvren_tpu_torch.ops.gather_plan.GatherPlan` (gathers and sums,
no scatter and no atomics), and unpacks the table gradient onto the grid
with K4. Repeat runs are bit-identical.

The split backward (:data:`BWD_SPLIT`, ``DVREN_BWD_SPLIT``) is the JAX
package's two-op route: under ``"pallas"`` K2 emits bank blocks (T, NB,
32, 128) and K6 (:func:`~dvren_tpu_torch.ops.packed_transpose.banks_to_rows`)
relays them to slot rows, in one launch, before the gather plan's sums;
under ``"xla"``, the default, K2 emits the slot rows itself. The two
give the same bits.
The flag is read on the routes where JAX reads it: a float32 32-column
flat table (sparse float32 bricks) and the dense float32 cell route of
:func:`render_tiled_stack`; the single-view dense :func:`render_tiled`,
16-bit tables and supercell schedules ignore it.

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
in the JAX package, with quantized and uniform shape classes; many views'
schedules merge into one (:func:`merge_view_schedules`) that
:func:`render_tiled_stack` renders with one launch over the merged groups.
Rays whose sub-tiles overflow the slot tables go to the windowed
fallback: the schedule carries a
:class:`~dvren_tpu_torch.render.windowed.WindowedSchedule` of them
(``fallback``), and the render overwrites their pixels with the windowed
path's results (K9f / K9b per fallback group). ``pitch=2`` packs lanes by
cell pairs, so the bank gather fetches two packed rows per index;
``occupancy=True`` trims each ray's step window to its non-empty cells;
``all_tiles=True`` puts every image tile in one uniform group, so a
schedule's shapes depend on the plan's geometry alone (the moving-camera
renderer, :mod:`dvren_tpu_torch.render.animate`). The schedule's hot loop
runs in the native scheduler core (:mod:`dvren_tpu_torch.native`), or in
numpy under ``DVREN_NATIVE_SCHED=0``; both give the same bytes.

With tracing on (:mod:`dvren_tpu_torch.utils.trace`) a render marks its
device stages: ``table`` (K3, K5a or the supercell table), ``gather``
(the bank gather), ``k1``, ``compose`` (the compose and any fallback);
its backward ``k2``, ``slot_reduce`` (the slot rows summed per table
row) and ``table_grad`` (K4, K5b or the supercell table's adjoint). The
host build is traced as the spans ``schedule.cascade``,
``schedule.build`` (and the counter ``schedule.builds``) and
``schedule.merge``.

Sample layout per (tile, chunk): block row r in [0, 16), lane l in
[0, 128), ray_in_tile = r * 16 + l // 8, step = l % 8; with n_sub
sub-tiles, sub-tile s owns the 16 // n_sub rows from s * (16 // n_sub).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch import native
from dvren_tpu_torch.core.plan import InterpMode, OobPolicy, Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.fields.sparse_grid import _SIGMA_CH, BRICK
from dvren_tpu_torch.ops import fused_tiles, packed_transpose
from dvren_tpu_torch.ops.compose import ImagePlanes, place_rays
from dvren_tpu_torch.ops.gather_plan import (build_gather_plan,
                                             slot_rows_to_table)
from dvren_tpu_torch.ops.grid import (NCH, build_supercell_stencil,
                                      fullpitch_rows, supercell_rows,
                                      table_dtype)
from dvren_tpu_torch.ops.raygen import generate_rays
from dvren_tpu_torch.render import windowed as windowed_mod
from dvren_tpu_torch.render.pipeline import plan_jitter_table
from dvren_tpu_torch.utils import trace

TILE_W = 16
TILE_H = 16
RAYS_PER_TILE = TILE_W * TILE_H
CHUNK = 8
MAX_CELLS = 128
_SENTINEL = np.int64(1) << 62
_DROP_TILE = 1 << 30     # tile id of pad tiles: compose drops it

# The split backward's relayout (``dvren_tpu``'s ``BWD_SPLIT``, read from
# DVREN_BWD_SPLIT at import): "pallas" makes K2 emit bank blocks and K6
# (packed_transpose.banks_to_rows, CUDA here; the value keeps JAX's name)
# relay them to slot rows; "xla" makes K2 emit the slot rows, the port's
# fused form of JAX's XLA relayout. Both give the same bits. Read when a
# route that honours it runs its forward, kept in its autograd node, and
# checked at its backward: any other value raises ValueError there.
BWD_SPLIT = os.environ.get("DVREN_BWD_SPLIT", "xla")
BWD_SPLIT_VALUES = ("xla", "pallas")


def _split_pallas(value: str) -> bool:
    """True for the bank-block route ("pallas"), False for "xla"."""
    if value not in BWD_SPLIT_VALUES:
        raise ValueError(f"DVREN_BWD_SPLIT must be one of "
                         f"{BWD_SPLIT_VALUES}, got {value!r}")
    return value == "pallas"

# Shape classes of quantized schedules: a group's (chunk count, bank count)
# rounds up to the nearest member, so every (nc, nb) pair maps to a small
# shared set (ratio <= 1.34 bounds the padding). Padded chunks hold masked
# samples only (exact zeros in every sum) and padded banks are never
# indexed (b1 clamps at nb - 1), so a quantized schedule renders the same
# frame bit for bit. ``dvren_tpu``'s ``_QUANT``.
_QUANT = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 20, 26, 32, 42, 52, 64, 84,
          104, 128, 168, 208, 256)


def _quant_up(v: int, cap: int | None = None) -> int:
    for q in _QUANT:
        if q >= v:
            return q if cap is None else min(q, cap)
    return v


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
    gathermap: np.ndarray    # pitch 1: the same array as ``hostmap``;
    #                          pitch 2: (T*banks*64,) the packed-row pair
    #                          per lane pair, -1 where neither lane is used
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


# The TileGroup arrays a schedule holds flat (TiledSchedule.tiles).
_FLAT_FIELDS = ("samp", "base", "rayt", "k_enter", "bank0")


@dataclass(frozen=True)
class TiledSchedule:
    """The host-resolved tile schedule (:func:`build_tiled_schedule`).
    ``tiles`` holds every group's samp, base, rayt, k_enter and bank0
    concatenated, with the per-tile descriptor of the one-launch kernels
    (:class:`~dvren_tpu_torch.ops.fused_tiles.TileSet`); the groups'
    arrays are views of it, as numpy arrays and after :meth:`to`."""

    groups: tuple            # of TileGroup
    fallback: object         # windowed.WindowedSchedule of the overflow
    #                          rays, or None (none, or a cascade probe)
    hostmap_all: np.ndarray  # (S,) int32 every group's hostmap, concatenated
    gathermap_all: np.ndarray  # (S / pitch,) int32 the bank gather's rows
    #                            (pitch 2: row pairs), every group's gathermap
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
    tiles: fused_tiles.TileSet | None = None   # the groups' arrays, flat
    tile_order: np.ndarray | None = None   # (T_kept,) int32 the kept tiles
    #                          in pitch 1's group order (pads left out): the
    #                          camera adjoint sums over them in this order
    #                          (:func:`_canonical_order`); None: every tile

    @property
    def subs(self) -> int:
        """Sub-tiles per 16x16 block: (16 // tile_px) ** 2."""
        return (16 // self.tile_px) ** 2

    def tile_set(self) -> fused_tiles.TileSet:
        """The flat arrays the one-launch kernels read: ``tiles``, or
        built from the groups when a caller took them away."""
        if self.tiles is not None:
            return self.tiles
        return fused_tiles.tile_set(self.groups, self.subs)

    def with_tiles(self, tiles=None) -> "TiledSchedule":
        """The schedule carrying ``tiles`` (by default the groups' arrays
        flattened), its groups' samp, base, rayt, k_enter and bank0 cut
        from them as views, so the schedule holds them once."""
        if tiles is None:
            tiles = fused_tiles.tile_set(self.groups, self.subs)
        return dataclasses.replace(self, tiles=tiles, groups=tuple(
            dataclasses.replace(g, **v)
            for g, v in zip(self.groups, tiles.group_arrays())))

    def to(self, device) -> "TiledSchedule":
        """The schedule with every array as a tensor on ``device``: the
        flat arrays moved once and the groups' views cut from them."""
        tiles = self.tile_set()
        bare = tuple(dataclasses.replace(g, **dict.fromkeys(_FLAT_FIELDS))
                     for g in self.groups)
        return dataclasses.replace(
            self,
            groups=tuple(g.to(device) for g in bare),
            fallback=(self.fallback.to(device)
                      if self.fallback is not None else None),
            hostmap_all=_to_device(self.hostmap_all, device),
            gathermap_all=_to_device(self.gathermap_all, device),
            gather_plan=(self.gather_plan.to(device)
                         if self.gather_plan is not None else None),
            tile_order=(None if self.tile_order is None
                        else _to_device(self.tile_order, device)),
        ).with_tiles(tiles.to(device))

    @property
    def device(self):
        """The device of the arrays, or None while they are numpy."""
        return (self.gathermap_all.device
                if isinstance(self.gathermap_all, torch.Tensor) else None)


# ----------------------------------------------------------------- host side


@trace.spanned("schedule.cascade")
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
    is None at 16 px cells. The probes skip the windowed fallback (only
    their overflow counts rank them); the chosen configuration is rebuilt
    with it when rays still overflow."""
    sched = build_tiled_schedule(plan, field, jitter=jitter,
                                 occupancy=occupancy, quantize=quantize,
                                 pitch=pitch, build_fallback=False)
    chosen = (16, 1)
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
                                      cell_scale=scale, build_fallback=False)
        if s_fine.fallback_rays < sched.fallback_rays:
            sched = s_fine
            chosen = (px, scale)
            note = (f"tiled_subtiled_{px}px" if scale == 1
                    else f"tiled_supercell_{px}px")
    if sched.fallback_rays:
        sched = build_tiled_schedule(plan, field, jitter=jitter,
                                     occupancy=occupancy, tile_px=chosen[0],
                                     quantize=quantize, pitch=pitch,
                                     cell_scale=chosen[1])
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


def _pack_runs_numpy(flat: np.ndarray, umax: int, pitch: int = 1,
                     pmax: int | None = None):
    """Per row of sample cell ids: stable sort, give each distinct cell its
    lane in sorted order (pitch 1: its rank; pitch 2: 2 * pair rank +
    (cell & 1), pairs being cell >> 1; the sentinel sorts last and gets
    none), and list the distinct (cell, lane) pairs, at most ``umax`` per
    row, and at pitch 2 the distinct pairs, at most ``pmax`` (the j-th has
    rank j). The numpy form of the native core's ``dvn_pack_runs``.

    Returns (lidx, lanes_run, ucell, ulane, n_u, upair, n_p): the
    per-sample lane, the run's lane count, the cells and lanes (-1 / 0
    padded) and their number, the pairs (-1 padded) and theirs. ``pmax``
    defaults to min(cols, 129)."""
    if pmax is None:
        pmax = min(flat.shape[1], MAX_CELLS + 1)
    order = np.argsort(flat, axis=1, kind="stable")
    sc = np.take_along_axis(flat, order, 1)
    new = np.ones(flat.shape, bool)
    new[:, 1:] = sc[:, 1:] != sc[:, :-1]
    rank = np.cumsum(new, axis=1, dtype=np.int32) - 1
    has_sent = sc[:, -1] == _SENTINEL
    if pitch == 2:
        pcs = np.where(sc == _SENTINEL, _SENTINEL, sc >> 1)
        new_p = np.ones(flat.shape, bool)
        new_p[:, 1:] = pcs[:, 1:] != pcs[:, :-1]
        prank = np.cumsum(new_p, axis=1, dtype=np.int32) - 1
        lane_sorted = (2 * prank + (sc & 1)).astype(np.int32)
        lanes_run = (2 * (prank[:, -1] + 1 - has_sent)).astype(np.int32)
    else:
        lane_sorted = rank
        lanes_run = (rank[:, -1] + 1 - has_sent).astype(np.int32)
    lidx = np.empty(flat.shape, np.int32)
    np.put_along_axis(lidx, order, lane_sorted, 1)

    def compact(vals, mask, width, lanes=None):
        # stable valid-first partition along the sorted axis
        ord2 = np.argsort(~mask, axis=1, kind="stable")
        n_v = np.minimum(mask.sum(1), width).astype(np.int32)
        within = np.arange(width)[None, :] < n_v[:, None]
        out = np.where(within, np.take_along_axis(vals, ord2[:, :width], 1),
                       -1)
        ln = None
        if lanes is not None:
            ln = np.where(within, np.take_along_axis(lanes, ord2[:, :width],
                                                     1), 0).astype(np.int32)
        return out, ln, n_v

    ucell, ulane, n_u = compact(sc, new & (sc != _SENTINEL), umax,
                                lane_sorted)
    if pitch == 2:
        upair, _, n_p = compact(pcs, new_p & (pcs != _SENTINEL), pmax)
    else:
        upair = np.full((flat.shape[0], pmax), -1, np.int64)
        n_p = np.zeros(flat.shape[0], np.int32)
    return lidx, lanes_run, ucell, ulane, n_u, upair, n_p


def _empty_cells(sigma) -> np.ndarray:
    """Full-pitch flat bool per grid cell: True where all 8 corner sigmas
    are exactly 0, so trilinear interpolation in the cell is 0 and
    skipping its samples changes nothing. The rows no clipped floor
    produces (ix == X - 1 and the like) count as empty. Host numpy, as in
    ``dvren_tpu``."""
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.detach().cpu().numpy()
    s = np.asarray(sigma) != 0.0
    occ = (s[:-1, :-1, :-1] | s[:-1, :-1, 1:] | s[:-1, 1:, :-1]
           | s[:-1, 1:, 1:] | s[1:, :-1, :-1] | s[1:, :-1, 1:]
           | s[1:, 1:, :-1] | s[1:, 1:, 1:])
    full = np.ones(s.shape, bool)
    full[:-1, :-1, :-1] = ~occ
    return full.reshape(-1)


def _empty_cells_sparse(field) -> np.ndarray:
    """Full-pitch flat bool per base cell of a sparse brick field: True
    where the cell's packed row (its 8 sigma corners) is exactly 0.
    Unoccupied bricks map to the shared zero brick (slot 0), so their
    cells are empty; a kept brick is tested row by row."""
    occ = field.occupancy.cpu().numpy()
    sig = field.bricks.detach()[:, :, list(_SIGMA_CH)]
    bempty = (sig == 0).all(dim=2).cpu().numpy()          # (NB, 512)
    nz, ny, nx = (int(v) for v in field.grid_shape)
    bz, by, bx = occ.shape
    cells = bempty[occ.reshape(-1)].reshape(bz, by, bx, BRICK, BRICK, BRICK)
    cells = cells.transpose(0, 3, 1, 4, 2, 5).reshape(
        bz * BRICK, by * BRICK, bx * BRICK)
    full = np.ones((nz, ny, nx), bool)
    full[:nz - 1, :ny - 1, :nx - 1] = cells[:nz - 1, :ny - 1, :nx - 1]
    return full.reshape(-1)


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


def _tighten_windows_by_occupancy(plan: Plan, o, d, k_enter_ray,
                                  k_count_ray, jitter, bbox_min, bbox_max,
                                  grid_shape, cell_empty, block=65536):
    """Each ray's step window [k_enter, k_enter + k_count) trimmed to its
    first..last lattice step whose sample (jittered, float32-exact) lands
    in a non-empty cell: (k_enter, k_count) int32. The trimmed steps
    contribute exact zeros, so the frame is unchanged. A ray with no such
    step gets (0, 0) (the schedule never reads k_enter where the count is
    0). The native core scans each ray forward to its first such step and
    back to its last; the numpy form evaluates every step of a block of
    rays (``dvren_tpu``'s ``_tighten_windows_by_occupancy``)."""
    nz, ny, nx = grid_shape
    dt = np.float32(plan.sampling.dt)
    t_near = np.float32(plan.t_near)
    t_far = np.float32(plan.t_far)
    k_max = plan.sampling.max_steps
    n = plan.ray_count
    hi = np.asarray(bbox_max)
    lo_d = np.asarray(bbox_min)
    inv_ext = np.where(hi != lo_d,
                       1.0 / np.maximum(hi - lo_d, 1e-30), 0.0).astype(
                           np.float32)
    lo = np.asarray(bbox_min, np.float32)
    nudge = np.nextafter(t_far, t_near, dtype=np.float32)
    if native.enabled():
        return native.tighten_occupancy(
            o, d, k_enter_ray, k_count_ray, jitter, float(t_near),
            float(t_far), float(dt), float(nudge), int(k_max), lo, inv_ext,
            (nx, ny, nz), cell_empty)

    npts = np.array([nx, ny, nz])
    new_ke = k_enter_ray.copy()
    new_cnt = k_count_ray.copy()
    for start in range(0, n, block):
        idx = np.arange(start, min(start + block, n))
        cnt = k_count_ray[idx]
        if not (cnt > 0).any():
            continue
        kw = int(cnt.max())
        k = k_enter_ray[idx, None] + np.arange(kw, dtype=np.int64)[None, :]
        in_win = np.arange(kw)[None, :] < cnt[:, None]
        base_t = t_near + k.astype(np.float32) * dt
        live = (base_t < t_far) & (k < k_max) & in_win
        if jitter is not None:
            jit = jitter[idx[:, None], np.minimum(k, jitter.shape[1] - 1)]
        else:
            jit = np.float32(0.5)
        t = (base_t + jit * dt).astype(np.float32)
        t = np.where(t >= t_far, nudge, t)
        ii = np.zeros(live.shape + (3,), np.int64)
        inside = np.ones(live.shape, bool)
        for ax in range(3):
            p = (o[idx, None, ax] + d[idx, None, ax] * t).astype(np.float32)
            local = ((p - lo[ax]) * inv_ext[ax]).astype(np.float32)
            inside &= (local >= 0.0) & (local <= 1.0)
            f = (local * np.float32(npts[ax] - 1)).astype(np.float32)
            ii[..., ax] = np.clip(np.floor(f), 0, npts[ax] - 2)
        cell = (ii[..., 2] * ny + ii[..., 1]) * nx + ii[..., 0]
        occ_live = live & inside & ~cell_empty[cell]
        any_live = occ_live.any(axis=1)
        first = np.argmax(occ_live, axis=1)
        last = kw - 1 - np.argmax(occ_live[:, ::-1], axis=1)
        new_ke[idx] = np.where(any_live, k_enter_ray[idx] + first, 0)
        new_cnt[idx] = np.where(any_live, last - first + 1, 0)
    return new_ke.astype(np.int32), new_cnt.astype(np.int32)


def _run_offsets(lanes_f: np.ndarray, bank_aligned: bool = False):
    """Dense bank packing of each tile's runs (T, runs): each run lands at
    the next free lane, a run of more than 128 lanes on a bank boundary;
    with ``bank_aligned`` also any run that would straddle one (so every
    run of at most 128 lanes lives in one bank). An empty run anchors at
    lane 0 (its samples are masked but must index a valid lane). Returns
    (the runs' lane offsets, each tile's lane count)."""
    lanes_f = lanes_f.astype(np.int64)
    offs = np.zeros(lanes_f.shape, np.int64)
    cur = np.zeros(lanes_f.shape[0], np.int64)
    for r in range(lanes_f.shape[1]):
        n_c = lanes_f[:, r]
        if bank_aligned:
            align = (n_c > 0) & (cur % MAX_CELLS + n_c > MAX_CELLS)
        else:
            align = n_c > MAX_CELLS
        cur = np.where(align, -(-cur // MAX_CELLS) * MAX_CELLS, cur)
        offs[:, r] = np.where(n_c > 0, cur, 0)
        cur += n_c
    return offs, cur


def _canonical_order(real_tiles, slot_tiles, n_tiles: int):
    """The order in which the backward sums over tiles, the same at pitch
    1 and pitch 2 and with bank-aligned runs: the kept tiles as the dense
    pitch-1 packing groups them, by (chunk count, its bank class, image
    block). Returns (tile_order, the (T_kept,) int32 indices of the kept
    tiles into the schedule's tile axis in that order; slot_key, an (S,)
    int64 key per slot, the tile's rank there times 2^16 plus the slot's
    lane in its tile). In the dense pitch-1 packing the keys rise with
    the slot index, so the gather plan sorts as ``dvren_tpu``'s does;
    where a tile's bank class can differ (pitch 2, bank-aligned runs),
    they keep that packing's order of each cell's slot rows (a tile's
    runs keep their order, only their lanes move)."""
    if not real_tiles:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    nc, nb1, block, pos = (np.concatenate(x) for x in zip(*real_tiles))
    tile_order = pos[np.lexsort((block, nb1, nc))]
    rank = np.zeros(n_tiles, np.int64)
    rank[tile_order] = np.arange(tile_order.size)
    slot_tile = np.concatenate(slot_tiles)
    starts = np.searchsorted(slot_tile, slot_tile, side="left")
    lane = np.arange(slot_tile.size) - starts
    return tile_order.astype(np.int32), (rank[slot_tile] << 16) + lane


def _lattice_runs_numpy(ot, dtn, safe, live_r, ke_t, nc: int, n_sub: int,
                        jitter, plan: Plan, bbox_min, inv_ext, grid_shape,
                        pitch: int, umax: int, pmax: int, cell_scale: int):
    """The numpy form of the native core's ``dvn_build_runs``: the sample
    lattice of a chunk-count class of tiles (every tile's rays from its
    window start, in the same float32 steps as ``dvren_tpu``'s builder),
    laid out as (T, nc, 16, 128), then the run pack of every (tile,
    chunk, sub-tile) row (:func:`_pack_runs_numpy`). Returns (st_l, m_l,
    lidx, lanes_run, ucell, ulane, n_u, upair, n_p); at ``cell_scale`` 2
    the packed ids are supercell ids and lidx carries each sample's cell
    in its supercell at bit 16."""
    nz, ny, nx = grid_shape
    t_cnt = int(ot.shape[0])
    k_steps = nc * CHUNK
    n = plan.ray_count
    dt = np.float32(plan.sampling.dt)
    t_near = np.float32(plan.t_near)
    t_far = np.float32(plan.t_far)
    k_max = plan.sampling.max_steps
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
    sample_t = np.where(sample_t >= t_far,
                        np.nextafter(t_far, t_near, dtype=np.float32),
                        sample_t)

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
        cell = ((iz >> 1) * (ny // 2) + (iy >> 1)) * (nx // 2) + (ix >> 1)
        lb = np.where(m, (ix & 1) + 2 * (iy & 1) + 4 * (iz & 1), 0)
    else:
        cell = (iz * ny + iy) * nx + ix               # full-pitch table row

    def to_lanes(a):
        # (T, 256, K) -> (T, nc, 16, 128): ray = row * 16 + lane // 8
        a = a.reshape(t_cnt, 16, 16, nc, CHUNK)
        a = a.transpose(0, 3, 1, 2, 4)
        return a.reshape(t_cnt, nc, 16, 128)

    sub_cols = (16 // n_sub) * 128
    cell_l = to_lanes(np.where(m, cell, _SENTINEL))
    m_l = to_lanes(m.astype(np.float32))
    st_l = to_lanes(np.broadcast_to(sample_t, (t_cnt, RAYS_PER_TILE,
                                               k_steps)))
    lidx, *rest = _pack_runs_numpy(cell_l.reshape(-1, sub_cols), umax,
                                   pitch, pmax)
    if cell_scale == 2:
        lidx = lidx | (to_lanes(lb).reshape(-1, sub_cols).astype(np.int32)
                       << 16)
    return (st_l, m_l, lidx, *rest)


def _check_slice(field):
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "tiled rendering requires an OOB_ZERO field")
    check(getattr(field, "interp", InterpMode.LINEAR) == InterpMode.LINEAR,
          "tiled rendering precomputes trilinear fractions; NEAREST fields "
          "must use the windowed/full paths")


@trace.spanned("schedule.build", counter="schedule.builds")
def build_tiled_schedule(plan: Plan, field, jitter=None,
                         occupancy: bool = False, tile_px: int = 16,
                         quantize: bool = False, pitch: int = 1,
                         cell_scale: int = 1,
                         uniform_shape: tuple | None = None,
                         all_tiles: bool = False,
                         bank_aligned: bool = False,
                         build_fallback: bool = True) -> TiledSchedule:
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
    256 slots overflows: its live rays are counted in ``fallback_rays``,
    its pixels left to them, and ``fallback`` holds their windowed
    schedule (numpy, moved with the rest by :meth:`TiledSchedule.to`); a
    supercell tile wider than 31 banks (the 12-bit lane) overflows whole.
    ``build_fallback=False`` counts the overflow rays without building
    their schedule (a cascade probe); such a schedule with overflow rays
    cannot be rendered.

    ``occupancy=True`` trims each ray's step window to its first..last
    sample in a non-empty cell (all 8 corner sigmas exactly 0 elsewhere):
    the frame is unchanged, and the schedule then depends on where the
    field's zeros are (reuse it only while they stay). ``pitch=2`` packs
    each run by cell pairs: a cell's lane is 2 * pair rank + (cell & 1),
    and ``gathermap`` names one packed-row pair per lane pair, so the bank
    gather fetches two rows per index (the partner lane of a lone cell
    stays -1 in ``hostmap``, which the backward reads); the frames and
    gradients are those of pitch 1 bit for bit. Supercells, and sparse
    fields with an odd x dimension (whose cell pairs are not brick-row
    pairs), take pitch 1; ``schedule.pitch`` says which was built.
    ``all_tiles=True`` (with ``quantize="uniform"`` or ``uniform_shape``)
    puts every image tile in the one group, those without a live ray fully
    masked, so the arrays' shapes depend only on the plan's geometry,
    ``uniform_shape``, ``tile_px`` and ``pitch``. ``bank_aligned=True``
    starts any run that would straddle a bank boundary at the next bank
    (``dvren_tpu``'s rule, about 1.18x the lanes at the headline), so each
    run of at most 128 cells sits in one bank and carries the ALIGNED bit;
    the frames and gradients are those of the dense packing bit for bit
    (the kernels here ignore the bit), and a tile pushed past the 15-bit
    lane id or the supercell's 31 banks is refused or overflows as in
    ``dvren_tpu``.

    ``quantize=True`` rounds each group's (chunk count, bank count) up to
    the ``_QUANT`` series; ``"uniform"`` gives every tile one class, the
    largest chunk and bank counts; ``uniform_shape=(nc, nb)`` pins that
    class (at least this schedule's maxima), so views built alike merge
    into one group (:func:`merge_view_schedules`). The frames are the same
    bit for bit: the padding holds masked samples and unread banks."""
    check(tile_px in (4, 8, 16), "tile_px must be 4, 8 or 16")
    check(pitch in (1, 2), "pitch must be 1 or 2")
    check(cell_scale in (1, 2), "cell_scale must be 1 or 2")
    check(not all_tiles or quantize == "uniform"
          or uniform_shape is not None,
          "all_tiles requires uniform quantization (one shape class)")
    sparse = hasattr(field, "bricks")
    if cell_scale == 2:
        check(not sparse,
              "cell_scale=2 (supercell tables) supports dense grids only")
        check(getattr(field, "packed_dtype", "float32") == "float32",
              "cell_scale=2 requires float32 tables")
        pitch = 1
    if pitch == 2 and sparse and int(field.grid_shape[2]) % 2:
        # with odd nx the flat-id pairs (2j, 2j + 1) wrap x rows, so the
        # partner is not at brick row(2j) + 1: pitch 1
        pitch = 1
    _check_slice(field)
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
    if occupancy:
        cell_empty = (_empty_cells_sparse(field) if sparse
                      else _empty_cells(field.sigma))
        k_enter_ray, k_count_ray = _tighten_windows_by_occupancy(
            plan, o, d, k_enter_ray.astype(np.int64),
            k_count_ray.astype(np.int64), jitter, bbox_min, bbox_max,
            (nz, ny, nx), cell_empty)

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
    uniform = quantize == "uniform" or uniform_shape is not None
    if uniform:
        live_nc = n_chunks_tile[tile_live & (n_chunks_tile > 0)]
        if live_nc.size or all_tiles:
            nc_u = int(live_nc.max()) if live_nc.size else 1
            if uniform_shape is not None:
                check(uniform_shape[0] >= nc_u,
                      "uniform_shape nc below this schedule's maximum")
                nc_u = int(uniform_shape[0])
            n_chunks_tile = np.where(tile_live & (n_chunks_tile > 0), nc_u,
                                     n_chunks_tile)
            if all_tiles:
                # every image tile joins the one group: a tile without a
                # live ray is fully masked, and its raw heads are the zero
                # tile the compose would place there
                tile_live = np.ones_like(tile_live)
                n_chunks_tile = np.full_like(n_chunks_tile, nc_u)
    elif quantize:
        nc_cap = -(-k_max // CHUNK)
        lut = np.array([_quant_up(v, nc_cap)
                        for v in range(int(n_chunks_tile.max()) + 1)]
                       if n_chunks_tile.size else [0], np.int64)
        n_chunks_tile = lut[n_chunks_tile]

    roi = plan.roi
    groups = []
    host_rows: list[np.ndarray] = []
    gmap_rows: list[np.ndarray] = []
    real_tiles: list[tuple] = []      # per group (nc, pitch-1 nb, block,
    #                                   tile index) of its kept tiles
    slot_tiles: list[np.ndarray] = []     # per group the tile of each slot
    n_tiles_all = 0
    fallback: list[np.ndarray] = []
    tiled_samples = 0
    pad_pid_base = plan.width * plan.height
    inv_ext = [np.float32(1.0 / (bbox_max[i] - bbox_min[i]))
               if bbox_max[i] != bbox_min[i] else np.float32(0.0)
               for i in range(3)]
    nudge = np.nextafter(t_far, t_near, dtype=np.float32)
    sub_cols = (16 // n_sub) * 128                  # samples per sub-tile run
    umax = min(sub_cols, 2 * MAX_CELLS + 1)
    pmax = min(sub_cols, MAX_CELLS + 1)
    use_native = native.enabled()

    for nc in sorted(set(n_chunks_tile[tile_live & (n_chunks_tile > 0)])):
        sel = np.nonzero(tile_live & (n_chunks_tile == nc))[0]
        nc = int(nc)
        t_cnt = sel.size

        ids = tiles[sel]                              # (T, 256)
        live_r = ray_live[sel]
        safe = np.maximum(ids, 0)
        ot = o[safe].astype(np.float32)               # (T, 256, 3)
        dtn = d[safe].astype(np.float32)
        ke_t = tile_ke[sel].astype(np.int64)          # (T,)

        if use_native:
            # the lattice and the run pack in one pass of the native core
            (st_l, m_l, lidx, lanes_run, ucell, ulane, n_u, upair,
             n_p) = native.build_runs(
                ot, dtn, safe, live_r, ke_t, nc, n_sub, float(t_near),
                float(t_far), float(dt), float(nudge), int(k_max), jitter,
                int(n), np.asarray(bbox_min, np.float32),
                np.asarray(inv_ext, np.float32), (nx, ny, nz), pitch,
                int(_SENTINEL), umax, pmax, cell_scale=cell_scale)
        else:
            (st_l, m_l, lidx, lanes_run, ucell, ulane, n_u, upair,
             n_p) = _lattice_runs_numpy(
                ot, dtn, safe, live_r, ke_t, nc, n_sub, jitter, plan,
                bbox_min, inv_ext, (nz, ny, nx), pitch, umax, pmax,
                cell_scale)
        lb_l = None
        if cell_scale == 2:
            # lidx's low 16 bits are the lane, bits 16.. the sample's cell
            # in its supercell (lx | ly << 1 | lz << 2)
            lb_l = (lidx >> 16).astype(np.int32)
            lidx = (lidx & 0xFFFF).astype(np.int32)

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
            row_bad = np.broadcast_to(
                sub_bad[:, None, :], (t_cnt, nc, n_sub)).reshape(-1)
            n_u = np.where(row_bad, 0, n_u)
            n_p = np.where(row_bad, 0, n_p)

        offs, cur = _run_offsets(lanes3.reshape(t_cnt, nc * n_sub),
                                 bank_aligned)
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
        if uniform:
            if (~overflow).any():
                nb_u = int(nb_tile[~overflow].max())
                if uniform_shape is not None:
                    check(uniform_shape[1] >= nb_u,
                          "uniform_shape nb below this schedule's maximum")
                    nb_u = int(uniform_shape[1])
                nb_tile = np.where(~overflow, nb_u, 0)
        elif quantize:
            nb_cap = 31 if cell_scale == 2 else None
            qmap = {int(v): _quant_up(int(v), nb_cap)
                    for v in np.unique(nb_tile[~overflow])}
            nb_tile = np.where(overflow, 0, np.vectorize(
                lambda v: qmap.get(int(v), 0), otypes=[np.int64])(nb_tile))
        # the bank class each tile would have in the dense pitch-1 packing
        # (its cells' lane count): the backward sums in that packing's
        # order at either pitch and with bank-aligned runs, so their
        # gradients equal its bit for bit
        nb_p1 = nb_tile
        if pitch == 2 or bank_aligned:
            _, cur1 = _run_offsets(n_u.reshape(t_cnt, nc * n_sub))
            nb_p1 = np.maximum(-(-cur1 // MAX_CELLS), 1)
            if uniform:
                nb_p1 = np.zeros_like(nb_p1)
            elif quantize:
                nb_p1 = np.array([_quant_up(int(v)) for v in nb_p1], np.int64)

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
            gmap = None                 # pitch 1: the gather reads hostmap
            if pitch == 2:
                # one packed-row pair per lane pair (runs start on even
                # lanes); a lone cell's partner lane stays -1 in hostmap,
                # so the backward's gather plan leaves it out
                gmap = np.full((t_kept, lanes // 2), -1, np.int64)
                n_p_k, upair_k = n_p[rowsel], upair[rowsel]
                prs, pcl = np.nonzero(
                    np.arange(upair.shape[1])[None, :] < n_p_k[:, None])
                gmap[prs // (nc * n_sub), off_k[prs] // 2 + pcl] = \
                    upair_k[prs, pcl]

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
            if gmap is not None and sparse:
                # pair ids in brick-row space: rows are x-minor in a brick
                # and BRICK is even, so a pair's even cell maps to an even
                # brick row and its partner to the next one
                even_rows = _sparse_rows_for_cells(
                    np.maximum(gmap, 0) * 2, occ_host, (nz, ny, nx))
                check(bool((even_rows[gmap >= 0] % 2 == 0).all()),
                      "sparse pair premise violated (a pair's even cell "
                      "maps to an odd brick row)")
                gmap = np.where(gmap >= 0, even_rows >> 1, -1)
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
                if gmap is not None:
                    gmap = pad(gmap, -1)
                bank0, ray_ids_k, ke_k = pad(bank0), pad(ray_ids_k), pad(ke_k)
                tile_ids_k = pad(tile_ids_k, _DROP_TILE)
                pad_ids = (pad_pid_base + np.arange(
                    extra * RAYS_PER_TILE)).reshape(extra, RAYS_PER_TILE)
                pad_pid_base += extra * RAYS_PER_TILE
                pids = np.concatenate([pids, pad_ids.astype(pids.dtype)])

            n_samples = int(m_l[keep].sum())
            tiled_samples += n_samples
            real_tiles.append((np.full(t_kept, nc), nb_p1[keep], sel[keep],
                               n_tiles_all + np.arange(t_kept)))
            slot_tiles.append(np.repeat(n_tiles_all + np.arange(t_pad),
                                        lanes))
            n_tiles_all += t_pad
            hm = uniq_r.reshape(-1)
            gm = hm if gmap is None else gmap.astype(np.int32).reshape(-1)
            host_rows.append(hm)
            gmap_rows.append(gm)
            groups.append(TileGroup(
                n_chunks=nc, n_tiles=t_pad, banks=nb,
                hostmap=hm, gathermap=gm, samp=samp, base=base, rayt=rayt,
                bank0=bank0, ray_ids=ray_ids_k, k_enter=ke_k,
                pixel_ids=pids.reshape(-1).astype(np.int32),
                tile_ids=tile_ids_k, samples=n_samples))

    fb = None
    fb_count = int(sum(f.size for f in fallback))
    if fb_count and build_fallback:
        fb = windowed_mod.build_schedule(
            plan, bbox_min, bbox_max, jitter=jitter,
            ray_subset=np.concatenate(fallback), device=False)
    hostmap_all = (np.concatenate(host_rows) if host_rows
                   else np.zeros(0, np.int32))
    gathermap_all = (np.concatenate(gmap_rows) if gmap_rows
                     else np.zeros(0, np.int32))
    tile_order, slot_key = _canonical_order(real_tiles, slot_tiles,
                                            n_tiles_all)
    if sparse:
        n_rows = int(field.bricks.shape[0]) * BRICK ** 3
    elif cell_scale == 2:
        n_rows = supercell_rows((nz, ny, nx))
    else:
        n_rows = fullpitch_rows((nz, ny, nx))
    return TiledSchedule(
        groups=tuple(groups), fallback=fb,
        hostmap_all=hostmap_all, gathermap_all=gathermap_all,
        gather_plan=build_gather_plan(hostmap_all, n_rows, slot_key),
        total_rays=n, tiled_samples=tiled_samples,
        full_lattice_samples=n * k_max,
        fallback_rays=fb_count,
        grid_shape=(nz, ny, nx), bbox=(bbox_min, bbox_max), tile_px=tile_px,
        table_kind="sparse" if sparse else "dense", pitch=pitch,
        cell_scale=cell_scale, tile_order=tile_order).with_tiles()


# --------------------------------------------------------------- device side


def _gather_banks_flat(table: torch.Tensor, gathermap_all: torch.Tensor,
                       pitch: int = 1) -> torch.Tensor:
    """Every group's bank blocks in one (S, w, 128) float32 array, group
    after group: the flat bank tables K1 and K2 read (a 16-bit table is
    widened after the gather). At pitch 2 ``gathermap_all`` names row
    pairs: the gather reads (S / 2, 2w) rows of ``table.view(-1, 2w)``,
    and row p of that holds lanes 2p and 2p + 1, so the bank blocks are
    laid out as at pitch 1 with half the indices. Dead lanes or pairs (-1)
    read row (pair) 0."""
    w = int(table.shape[1])
    if pitch == 2:
        check(int(table.shape[0]) % 2 == 0,
              f"a pitch-2 schedule gathers row pairs: the table's "
              f"{int(table.shape[0])} rows must be even")
        table = table.contiguous().view(-1, 2 * w)
    rows = torch.index_select(table, 0, gathermap_all.clamp(min=0))
    if pitch == 2:
        rows = rows.reshape(-1, w)
    if rows.dtype != torch.float32:
        rows = rows.float()
    return rows.reshape(-1, MAX_CELLS, w).transpose(1, 2).contiguous()


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
    banks = _gather_banks_flat(table, gathermap_all)
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
    keep the background (T = 1, depth = t_far), unless a fallback part
    (pixel ids, radiance, T, opacity, depth; windowed
    ``_group_outputs``) overwrites their pixels, as
    ``dvren_tpu``'s ``_compose_tiles`` does. Differentiable in ``raws``
    and the parts. ``device``: where the planes of an empty schedule (no
    ``raws``, no parts) are built."""
    roi = plan.roi
    n_tiles = (-(-roi.width // tile_px)) * (-(-roi.height // tile_px))
    if raws:
        raw = raw_to_subtiles(raws[0] if len(raws) == 1 else torch.cat(raws),
                              tile_px)
        ids = torch.cat([t.reshape(-1) for t in tile_ids]).long()
        tiles5 = _PlaceTiles.apply(raw, ids, n_tiles)
    else:
        tiles5 = torch.zeros((n_tiles, 5, tile_px, tile_px),
                             dtype=torch.float32, device=device)
    image, trans, opac, dep = tiles5_to_planes(plan, tiles5, tile_px)
    if fallback_parts:
        h, w = plan.height, plan.width
        pids = torch.cat([p[0] for p in fallback_parts])
        heads = [torch.cat([p[i] for p in fallback_parts]) for i in (1, 2, 3,
                                                                       4)]
        image = place_rays(image.reshape(h * w, 3), pids,
                           heads[0]).reshape(h, w, 3)
        trans, opac, dep = (
            place_rays(x.reshape(h * w), pids, v).reshape(h, w)
            for x, v in zip((trans, opac, dep), heads[1:]))
    return ImagePlanes(image=image, transmittance=trans, opacity=opac,
                       depth=dep,
                       hitmask=windowed_mod.roi_hitmask(plan, image.device))


class _GroupsetFromParams(torch.autograd.Function):
    """Dense-grid params -> the raw K1 output of every tile of the
    schedule, (T, 5, 16, 16) in group order, as one autograd node: the
    counterpart of ``dvren_tpu``'s ``_groupset_from_params`` and, when
    ``split``, of its ``bank_tables_from_params`` (the route
    ``render_tiled_stack`` takes).

    Forward: the packed table (K3), the bank gather into one flat array,
    one K1 launch over every group. Backward: one K2 launch, whose slot
    rows are the one buffer :func:`slot_rows_to_table` reads, then K4;
    with ``split`` under ``BWD_SPLIT == "pallas"``, K2's bank blocks and
    one K6 launch (:func:`_cts_to_rows`) in place of the rows. Returns
    (None, d_sigma, d_color, d_rayt). Autograd never records the table
    gather: its backward would be ``index_add_``. ``static`` = (schedule,
    TileParams of the launch, use_kernel, cam, split); on CPU tensors
    every kernel step runs its plain twin, group by group."""

    @staticmethod
    def forward(ctx, static, sigma, color, rayt):
        schedule, prm, use_kernel, cam, split = static
        if use_kernel:
            table = packed_transpose.build_rows(sigma, color)
            forward = fused_tiles.tile_forward
        else:
            table = packed_transpose.build_rows_plain(sigma, color)
            forward = fused_tiles.tile_forward_set_plain
        trace.stage("gather")
        tabs = _gather_banks_flat(table, schedule.gathermap_all,
                                  schedule.pitch)
        trace.stage("k1")
        raw = forward(tabs, schedule.tiles, prm, rayt)
        ctx.static = static
        ctx.split = BWD_SPLIT if split else "xla"
        ctx.tabs = tabs
        ctx.grid_shape = tuple(sigma.shape)
        ctx.save_for_backward(rayt)
        return raw

    @staticmethod
    def backward(ctx, g_raw):
        schedule, use_kernel = ctx.static[0], ctx.static[2]
        want_grid = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        trace.stage("k2")
        rows, d_rayt = _k2_tiles(ctx, g_raw, want_grid)
        d_sigma = d_color = None
        if want_grid:
            trace.stage("slot_reduce")
            table_grad = slot_rows_to_table(
                rows, schedule.gather_plan, fullpitch_rows(ctx.grid_shape))
            trace.stage("table_grad")
            unpack = (packed_transpose.table_grad_to_params if use_kernel
                      else packed_transpose.table_grad_to_params_plain)
            d_sigma, d_color = unpack(table_grad, ctx.grid_shape)
        return None, d_sigma, d_color, d_rayt


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
    """Any (R, C) table (float32, bfloat16 or float16) -> the raw K1
    output of every tile of the schedule, (T, 5, 16, 16), as one autograd
    node: the flat-table route of ``dvren_tpu``'s ``render_tiled`` (a
    16-bit dense table, a sparse field's bricks, or the (R_s, 108)
    supercell table).

    Forward: the bank gather into one flat array, widened to f32 after
    it, then one K1 launch over every group. Backward: one K2 launch (f32
    slot rows, and d(rayt) when ``cam``). For a 16-bit table every slot
    row is rounded to the table's dtype, as the JAX cotangent of the
    widening cast is; the rows of each cell are then summed in f32 in the
    gather plan's fixed order (:func:`slot_rows_to_table`) and the sums
    rounded once to the table's dtype. (JAX's scatter-add adds in the
    16-bit dtype, in scatter order.) Returns (None, d_table in the
    table's dtype, d_rayt). ``static`` = (schedule, TileParams of the
    launch, use_kernel, cam, split): ``split`` for a float32 32-column
    table (sparse float32 bricks), whose backward then follows
    ``BWD_SPLIT`` as ``dvren_tpu``'s ``_gather_bank_tables`` does."""

    @staticmethod
    def forward(ctx, static, table, rayt):
        schedule, prm, use_kernel, cam, split = static
        forward = (fused_tiles.tile_forward if use_kernel
                   else fused_tiles.tile_forward_set_plain)
        trace.stage("gather")
        tabs = _gather_banks_flat(table, schedule.gathermap_all,
                                  schedule.pitch)
        trace.stage("k1")
        raw = forward(tabs, schedule.tiles, prm, rayt)
        ctx.static = static
        ctx.split = BWD_SPLIT if split else "xla"
        ctx.tabs = tabs
        ctx.table_meta = (int(table.shape[0]), table.dtype)
        ctx.save_for_backward(rayt)
        return raw

    @staticmethod
    def backward(ctx, g_raw):
        schedule = ctx.static[0]
        n_rows, dtype = ctx.table_meta
        trace.stage("k2")
        rows, d_rayt = _k2_tiles(ctx, g_raw, ctx.needs_input_grad[1])
        d_table = None
        if ctx.needs_input_grad[1]:
            trace.stage("slot_reduce")
            d_table = slot_rows_to_table_as(rows, schedule.gather_plan,
                                            n_rows, dtype)
            # the table's own adjoint (K5b, the supercell stencil's
            # autograd backward) runs after this node returns
            trace.stage("table_grad")
        return None, d_table, d_rayt


def _k2_tiles(ctx, g_raw, want_table: bool):
    """One K2 launch over every group of a groupset node's backward ->
    ((S, C) f32 slot rows of all groups, or None without ``want_table``;
    d(rayt) (T, 12, 128) or None). Under the split route (``ctx.split``
    "pallas") K2 emits bank blocks and one K6 launch relays them
    (:func:`_cts_to_rows`)."""
    schedule, prm, use_kernel, cam, _ = ctx.static
    pallas = _split_pallas(ctx.split)
    emit = "banks" if pallas and want_table else "rows"
    backward = (fused_tiles.tile_backward if use_kernel
                else fused_tiles.tile_backward_set_plain)
    (rayt,) = ctx.saved_tensors
    d_part, d_rayt = backward(ctx.tabs, schedule.tiles, g_raw.contiguous(),
                              prm, cam, emit=emit, rayt=rayt)
    if not want_table:
        return None, d_rayt
    if emit == "banks":
        return _cts_to_rows(d_part, use_kernel), d_rayt
    return d_part.reshape(-1, d_part.shape[-1]), d_rayt


def _cts_to_rows(banks: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """Every group's bank cotangents (S_b, 32, 128) -> (S_b * 128, 32) f32
    slot rows, in one K6 launch (``dvren_tpu``'s ``_cts_to_ct16`` under
    ``BWD_SPLIT="pallas"``, whose rows these equal as ``hi << 16 | lo``;
    K6 here needs no multiple of 8 blocks, so nothing falls back).
    ``use_kernel=False`` runs K6's twin."""
    if use_kernel:
        return packed_transpose.banks_to_rows(banks)
    return packed_transpose.banks_to_rows_plain(banks)


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


def _traced_rayts(plan: Plan, schedule: TiledSchedule, k, c2w,
                  ortho_scale=None):
    """The (T, 12, 128) ray planes of every tile, rebuilt from the camera
    tensors ``k`` / ``c2w`` / ``ortho_scale`` (autograd records them; what
    is None is the plan's), for the rays the
    schedule baked in: dead lanes carry ray 0 there too. The rays are
    generated in ``schedule.tile_order`` and placed at their tiles (pad
    tiles get zero planes), so the camera adjoint sums over the tiles in
    that order, the same at pitch 1 and 2."""
    ids = torch.cat([g.ray_ids.reshape(-1, RAYS_PER_TILE)
                     for g in schedule.groups])
    n_all = int(ids.shape[0])
    order = schedule.tile_order
    if order is not None:
        ids = torch.index_select(ids, 0, order.long())
    rays = generate_rays(plan, k=k, c2w=c2w, ortho_scale=ortho_scale,
                         ids=ids.reshape(-1))
    nt = int(ids.shape[0])
    o = rays.origins.reshape(nt, 2, 128, 3)
    d = rays.directions.reshape(nt, 2, 128, 3)
    rayt = torch.stack([o[..., i] for i in range(3)]
                       + [d[..., i] for i in range(3)],
                       dim=1).reshape(nt, 12, 128)
    if order is None:
        return rayt
    return _PlaceTiles.apply(rayt, order.long(), n_all)


def _check_field_schedule(field, schedule: TiledSchedule, what: str):
    """The checks every tiled render makes of (field, schedule); returns
    the field's device."""
    check(tuple(float(v) for v in field.bbox_min) == tuple(schedule.bbox[0])
          and tuple(float(v) for v in field.bbox_max)
          == tuple(schedule.bbox[1]),
          f"{what} was built for a different field bbox (cell ids and "
          "fraction constants depend on it)")
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "tiled rendering requires an OOB_ZERO field")
    sparse = hasattr(field, "bricks")
    kind = "sparse" if sparse else "dense"
    check(schedule.table_kind == kind,
          f"{what} was built for a {schedule.table_kind} field, this one "
          f"is {kind}")
    shape = field.grid_shape if sparse else field.sigma.shape[:3]
    check(tuple(int(v) for v in shape) == tuple(schedule.grid_shape),
          f"{what} was built for a different grid resolution")
    check(schedule.cell_scale == 1
          or getattr(field, "packed_dtype", "float32") == "float32",
          "supercell schedules need float32 tables")
    device = field.bricks.device if sparse else field.sigma.device
    check(schedule.device == device,
          f"{what} is on {schedule.device}, the field on {device}: "
          f"move it with .to(device)")
    return device


def _tiles_raw(plan: Plan, field, schedule: TiledSchedule,
               use_kernel: bool, rayt=None, stack: bool = False):
    """The raw heads (T, 5, 16, 16) of every tile of the schedule, in
    group order, for ``field`` through the route its table takes (see
    :func:`render_tiled`): one table build, one planned bank gather and
    one K1 launch over every group, in the schedule's form, as one
    autograd node; None for an empty schedule. ``rayt``: ray planes
    that autograd records (the camera adjoint), else the schedule's.
    ``stack``: the caller is :func:`render_tiled_stack`, whose dense
    float32 cell route reads ``BWD_SPLIT`` (the single-view one does not,
    as in JAX)."""
    if not schedule.groups:
        return None
    trace.stage("table")
    schedule = dataclasses.replace(schedule, tiles=schedule.tile_set())
    geom = (schedule.bbox[0], schedule.bbox[1], schedule.grid_shape)
    stencil = "super" if schedule.cell_scale == 2 else "cell"
    prm = fused_tiles.tiles_op_params(plan, geom, schedule.tiles, stencil)
    cam = rayt is not None
    if not cam:
        rayt = schedule.tiles.rayt
    static = (schedule, prm, use_kernel, cam, False)
    split = (schedule, prm, use_kernel, cam, True)
    if hasattr(field, "bricks"):
        bricks = field.bricks.reshape(-1, NCH)
        return _GroupsetFromTable.apply(
            split if bricks.dtype == torch.float32 else static, bricks,
            rayt)
    if schedule.cell_scale == 2:
        return _GroupsetFromTable.apply(
            static, build_supercell_stencil(field.sigma, field.color), rayt)
    if getattr(field, "packed_dtype", "float32") == "float32":
        return _GroupsetFromParams.apply(split if stack else static,
                                         field.sigma, field.color, rayt)
    table = _Table16FromParams.apply(
        (table_dtype(field.packed_dtype), use_kernel), field.sigma,
        field.color)
    return _GroupsetFromTable.apply(static, table, rayt)


def render_tiled(plan: Plan, field, schedule: TiledSchedule,
                 use_kernel: bool = True, k=None, c2w=None,
                 camera=None) -> ImagePlanes:
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
    :class:`_GroupsetFromTable`, whose backward follows :data:`BWD_SPLIT`
    for float32 bricks. K1 and K2 run in the schedule's form:
    (16 // tile_px) ** 2 sub-tiles per block, the supercell stencil at
    cell_scale 2.

    The schedule must be on the field's device (:meth:`TiledSchedule.to`).
    ``use_kernel=False`` runs the plain PyTorch twins of the kernels on
    that device: the reference the kernels are held to. With ``k`` or
    ``c2w`` the ray planes are rebuilt from those tensors and the backward
    emits their adjoint; the cells, slots and mask stay the schedule's, so
    a camera far from the schedule's needs a new schedule. The fallback's
    rays render through the windowed path's groups (K9f / K9b), under the
    same camera tensors; ``camera`` (k, c2w, ortho_scale), the plan's
    camera as tensors, fills in what ``k`` / ``c2w`` leave out, for the
    rebuilt ray planes and the fallback (else they upload the plan's
    camera at each call, which a CUDA graph cannot record)."""
    device = _check_field_schedule(field, schedule, "schedule")
    check(schedule.fallback is not None or schedule.fallback_rays == 0,
          f"the schedule was built with build_fallback=False (a cascade "
          f"probe) but has {schedule.fallback_rays} overflow rays: rebuild "
          f"it with the fallback")
    ck, cc, co = (None, None, None) if camera is None else camera
    rayt = None
    if (k is not None or c2w is not None) and schedule.groups:
        rayt = _traced_rayts(plan, schedule, ck if k is None else k,
                             cc if c2w is None else c2w, co)
    raw = _tiles_raw(plan, field, schedule, use_kernel, rayt)
    trace.stage("compose")
    parts = _fallback_parts(plan, field, schedule.fallback,
                            k=ck if k is None else k,
                            c2w=cc if c2w is None else c2w, ortho_scale=co,
                            use_kernel=use_kernel)
    return _compose_tiles(plan, [] if raw is None else [raw],
                          [g.tile_ids for g in schedule.groups], parts,
                          tile_px=schedule.tile_px, device=device)


def _fallback_parts(plan: Plan, field, fallback, k=None, c2w=None,
                    ortho_scale=None, use_kernel: bool = True) -> list:
    """Per fallback group, the windowed path's per-ray parts. The groups
    mark the windowed path's stages (``utils/trace.py``); the tile
    compose's stage resumes after them."""
    if fallback is None or not fallback.groups:
        return []
    parts = [windowed_mod._group_outputs(plan, budget, field, ids, ke, jit,
                                         k=k, c2w=c2w,
                                         ortho_scale=ortho_scale,
                                         use_kernel=use_kernel)
             for budget, ids, ke, jit in fallback.groups]
    trace.stage("compose")
    return parts


# ------------------------------------------------------------ many views


@dataclass(frozen=True)
class MergedViewSchedule:
    """Every view's tile groups merged by (chunk count, bank count) class
    (``dvren_tpu``'s ``MergedViewSchedule``). Tiles are independent, so
    the tiles of all views that share a class form one group: one table
    build, one planned gather and one kernel launch per class serve every
    view.

    ``view_slices``: per merged group, the (view, t_start, t_count) runs
    of its tile axis, view-major. ``view_fallbacks``: per view, its
    windowed fallback schedule or None. ``view_cams``: per view (k, c2w,
    ortho_scale) when ``merge_view_schedules`` had the plans: fallback
    rays are generated at render time, under their view's camera.
    ``view_cam_tensors``: those cameras as float32 tensors (k (3, 3), c2w
    (3, 4), ortho_scale ()) on the schedule's device, uploaded once by
    :meth:`to`, so a render that a CUDA graph records uploads nothing."""

    sched: TiledSchedule
    view_fallbacks: tuple
    view_slices: tuple
    n_views: int
    view_cams: tuple | None = None
    view_cam_tensors: tuple | None = None

    def to(self, device) -> "MergedViewSchedule":
        cams = None
        if self.view_cams is not None:
            cams = tuple(_view_cam_tensors(cam, device)
                         for cam in self.view_cams)
        return dataclasses.replace(
            self, sched=self.sched.to(device),
            view_fallbacks=tuple(None if f is None else f.to(device)
                                 for f in self.view_fallbacks),
            view_cam_tensors=cams)


def _view_cam_tensors(cam, device) -> tuple:
    """A view's (k, c2w, ortho_scale) floats as float32 tensors (3, 3),
    (3, 4) and () on ``device``."""
    k, c2w, ortho_scale = cam
    return (torch.tensor(k, dtype=torch.float32, device=device).reshape(3, 3),
            torch.tensor(c2w, dtype=torch.float32,
                         device=device).reshape(3, 4),
            torch.tensor(ortho_scale, dtype=torch.float32, device=device))


@trace.spanned("schedule.merge")
def merge_view_schedules(scheds, plans=None) -> MergedViewSchedule:
    """Merge per-view numpy schedules (one plan geometry, one field, one
    tile_px and cell_scale) into a :class:`MergedViewSchedule`, its
    arrays numpy as well, with the gather plan built over the
    concatenated hostmaps; move it with :meth:`MergedViewSchedule.to`.
    Build the views with ``quantize="uniform"`` and one ``uniform_shape``
    to get one group. Each view keeps its windowed fallback; ``plans``
    (one per view) must be given when a view has one, since its rays are
    generated at render time under the view's camera."""
    base = scheds[0]
    for s in scheds:
        check(s.fallback is not None or s.fallback_rays == 0,
              "merge_view_schedules: a view schedule was built with "
              "build_fallback=False but has overflow rays")
        check(s.device is None,
              "merge_view_schedules: build the views as numpy schedules "
              "(they merge on the host and move once)")
    for s in scheds[1:]:
        check(s.tile_px == base.tile_px
              and s.grid_shape == base.grid_shape
              and s.bbox == base.bbox
              and s.table_kind == base.table_kind
              and s.pitch == base.pitch
              and s.cell_scale == base.cell_scale,
              "merge_view_schedules: schedules must share tile_px, pitch, "
              "cell_scale, grid and bbox (build all views at one tile_px)")
    keys = sorted({(g.n_chunks, g.banks) for s in scheds for g in s.groups})
    merged, slices_all, host_parts, gmap_parts = [], [], [], []
    t_samples = 0
    for key in keys:
        parts, slices, t_off = [], [], 0
        for v, s in enumerate(scheds):
            for g in s.groups:
                if (g.n_chunks, g.banks) == key:
                    parts.append(g)
                    slices.append((v, t_off, g.n_tiles))
                    t_off += g.n_tiles
        t_samples += sum(p.samples for p in parts)

        def cat(name):
            vals = [getattr(p, name) for p in parts]
            return vals[0] if len(vals) == 1 else np.concatenate(vals)

        host_parts.extend(p.hostmap for p in parts)
        gmap_parts.extend(p.gathermap for p in parts)
        hostmap = cat("hostmap")
        merged.append(TileGroup(
            n_chunks=key[0], n_tiles=t_off, banks=key[1],
            hostmap=hostmap, gathermap=cat("gathermap"), samp=cat("samp"),
            base=cat("base"), rayt=cat("rayt"), bank0=cat("bank0"),
            ray_ids=cat("ray_ids"), k_enter=cat("k_enter"),
            pixel_ids=cat("pixel_ids"), tile_ids=cat("tile_ids"),
            samples=sum(p.samples for p in parts)))
        slices_all.append(tuple(slices))

    hostmap_all = (np.concatenate(host_parts) if host_parts
                   else np.zeros(0, np.int32))
    gathermap_all = (np.concatenate(gmap_parts) if gmap_parts
                     else np.zeros(0, np.int32))
    n_rows = next((int(s.gather_plan.inv_map.shape[0]) for s in scheds
                   if s.gather_plan is not None), 1)
    sched = TiledSchedule(
        groups=tuple(merged), fallback=None,
        hostmap_all=hostmap_all, gathermap_all=gathermap_all,
        gather_plan=build_gather_plan(hostmap_all, n_rows),
        total_rays=sum(s.total_rays for s in scheds),
        tiled_samples=t_samples,
        full_lattice_samples=sum(s.full_lattice_samples for s in scheds),
        fallback_rays=sum(s.fallback_rays for s in scheds),
        grid_shape=base.grid_shape, bbox=base.bbox,
        tile_px=base.tile_px, table_kind=base.table_kind,
        pitch=base.pitch, cell_scale=base.cell_scale).with_tiles()
    view_cams = None
    if plans is not None:
        check(len(plans) == len(scheds),
              "merge_view_schedules: one plan per schedule")
        view_cams = tuple(
            (tuple(float(v) for v in p.camera.k),
             tuple(float(v) for v in p.camera.c2w),
             float(p.camera.ortho_scale)) for p in plans)
    check(plans is not None or all(s.fallback is None for s in scheds),
          "merge_view_schedules: a view has fallback (slot-overflow) rays, "
          "which are generated at render time: pass plans= so each uses "
          "its own camera")
    return MergedViewSchedule(
        sched=sched, view_fallbacks=tuple(s.fallback for s in scheds),
        view_slices=tuple(slices_all), n_views=len(scheds),
        view_cams=view_cams)


def render_tiled_stack(plan: Plan, field, merged: MergedViewSchedule,
                       use_kernel: bool = True) -> torch.Tensor:
    """Render every merged view in one pass -> the (V, H, W, 3) image
    stack, differentiable in the field as :func:`render_tiled` is.

    One table build, one planned bank gather and one K1 launch over every
    merged group serve every view (K2 likewise in the backward); each
    view's image is composed from its slices of each group's part of the
    output (``view_slices``). The backward of the dense float32 cell route, and
    of sparse float32 bricks, follows :data:`BWD_SPLIT` (K2's bank blocks
    and K6 under "pallas"). ``use_kernel=False`` runs the twins. ``plan`` is
    any view's plan: the views share its geometry and sampling, and each
    group's rays were baked in per view when its schedule was built."""
    sched = merged.sched
    device = _check_field_schedule(field, sched, "merged schedule")
    raw = _tiles_raw(plan, field, sched, use_kernel, stack=True)
    group_t0 = [t0 for t0, _, _ in sched.tile_set().offsets()]
    trace.stage("compose")
    images = []
    for v in range(merged.n_views):
        parts = []
        fb = merged.view_fallbacks[v]
        if fb is not None:
            check(merged.view_cams is not None,
                  "merged schedule has fallback rays but no per-view "
                  "cameras; rebuild with merge_view_schedules(plans=...)")
            check(merged.view_cam_tensors is not None,
                  "the merged schedule's per-view cameras are not on the "
                  "device: move it with .to(device)")
            cam_k, cam_c2w, cam_os = merged.view_cam_tensors[v]
            parts = _fallback_parts(plan, field, fb, k=cam_k, c2w=cam_c2w,
                                    ortho_scale=cam_os,
                                    use_kernel=use_kernel)
        raws_v, ids_v = [], []
        for gi, group in enumerate(sched.groups):
            for vv, t0, cnt in merged.view_slices[gi]:
                if vv == v:
                    at = group_t0[gi] + t0
                    raws_v.append(raw[at:at + cnt])
                    ids_v.append(group.tile_ids[t0:t0 + cnt])
        images.append(_compose_tiles(plan, raws_v, ids_v, parts,
                                     tile_px=sched.tile_px,
                                     device=device).image)
    return torch.stack(images)
