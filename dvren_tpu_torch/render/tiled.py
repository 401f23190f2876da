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

The schedule is built in numpy, as the JAX package builds it, and its
arrays equal that package's array for array (``gather_plan``, which only
the backward needs, is not built). This slice supports what the headline
render needs: 16 px tiles, pitch 1, one slot per grid cell, dense float32
fields, no occupancy trimming and no windowed fallback. Anything else
raises ``NotImplementedError`` naming its ROADMAP item.

Sample layout per (tile, chunk): block row r in [0, 16), lane l in
[0, 128), ray_in_tile = r * 16 + l // 8, step = l % 8.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch.core.plan import InterpMode, OobPolicy, Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops import fused_tiles, packed_transpose
from dvren_tpu_torch.ops.compose import ImagePlanes
from dvren_tpu_torch.ops.grid import NCH
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
_TODO_SUBTILES = "sub-tiled and supercell schedules (ROADMAP Queue 1 item 10)"
_TODO_PITCH2 = "pitch-2 packing (ROADMAP Queue 1 item 5)"
_TODO_OCCUPANCY = "occupancy trimming (ROADMAP Queue 1 item 5)"
_TODO_MULTIVIEW = "quantized and uniform schedules (ROADMAP Queue 1 item 13)"
_TODO_SPARSE = "sparse fields and 16-bit tables (ROADMAP Queue 1 item 12)"


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
    #                          sample_t lo16, tile lane | mask << 15];
    #                          integer data, only bit ops may touch it
    base: np.ndarray         # (T, banks, 3, 128) f32 lane cell base (x,y,z)
    rayt: np.ndarray         # (T, 12, 128) f32 ray planes, row ax*2 + half,
    #                          lane ray % 128, axes (ox, oy, oz, dx, dy, dz)
    bank0: np.ndarray        # (T, nc, 1) int32 window start bank (bits
    #                          0..13) | ALIGNED << 30 (used by the backward)
    ray_ids: np.ndarray      # (T, 256) int32 global ray id (dead -> 0)
    k_enter: np.ndarray      # (T,) int32 tile window start step
    pixel_ids: np.ndarray    # (T*256,) int32 compose targets per ray
    tile_ids: np.ndarray     # (T, 1) int32 ROI tile index (pads: 1 << 30)
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
    total_rays: int
    tiled_samples: int
    full_lattice_samples: int
    fallback_rays: int       # rays whose tiles overflow the slot tables
    grid_shape: tuple        # (nz, ny, nx) the cell ids index
    bbox: tuple              # ((min), (max)) the windows and cells assume
    tile_px: int = 16
    table_kind: str = "dense"
    pitch: int = 1
    cell_scale: int = 1

    def to(self, device) -> "TiledSchedule":
        """The schedule with every array as a tensor on ``device``."""
        return dataclasses.replace(
            self,
            groups=tuple(g.to(device) for g in self.groups),
            hostmap_all=_to_device(self.hostmap_all, device),
            gathermap_all=_to_device(self.gathermap_all, device))

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
    """Build the 16 px cell-table schedule; returns (schedule, None).

    The JAX package cascades to supercell and sub-tiled schedules when
    more than a tenth of the rays overflow, and renders the remaining
    overflow rays through the windowed path; this slice has neither, so
    any overflow raises ``NotImplementedError``."""
    sched = build_tiled_schedule(plan, field, jitter=jitter,
                                 occupancy=occupancy, quantize=quantize,
                                 pitch=pitch)
    if sched.fallback_rays * 10 > sched.total_rays:
        raise NotImplementedError(
            f"{sched.fallback_rays} of {sched.total_rays} rays overflow the "
            f"16 px slot tables: needs {_TODO_SUBTILES}")
    if sched.fallback_rays:
        raise NotImplementedError(
            f"{sched.fallback_rays} rays overflow the slot tables: needs "
            f"{_TODO_FALLBACK}")
    return sched, None


def _tile_rays(plan: Plan):
    """Global ray ids per 16x16 tile, (n_tiles, 256) row-major with -1
    past the ROI edge, and each tile's ROI tile index, (n_tiles, 1)."""
    roi = plan.roi
    tx_n = -(-roi.width // TILE_W)
    ty_n = -(-roi.height // TILE_H)
    ys = (np.arange(ty_n)[:, None, None, None] * TILE_H
          + np.arange(TILE_H)[None, None, :, None])
    xs = (np.arange(tx_n)[None, :, None, None] * TILE_W
          + np.arange(TILE_W)[None, None, None, :])
    ids = np.where((ys < roi.height) & (xs < roi.width),
                   ys * roi.width + xs, -1)
    tiles = ids.reshape(ty_n * tx_n, RAYS_PER_TILE)
    return tiles, np.arange(ty_n * tx_n).reshape(-1, 1)


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


def _check_slice(field, tile_px, pitch, cell_scale, occupancy, quantize,
                 uniform_shape, all_tiles, bank_aligned):
    if tile_px != 16 or cell_scale != 1:
        raise NotImplementedError(_TODO_SUBTILES)
    if pitch != 1:
        raise NotImplementedError(_TODO_PITCH2)
    if occupancy:
        raise NotImplementedError(_TODO_OCCUPANCY)
    if quantize or uniform_shape is not None or all_tiles or bank_aligned:
        raise NotImplementedError(_TODO_MULTIVIEW)
    if (hasattr(field, "bricks")
            or getattr(field, "packed_dtype", "float32") != "float32"):
        raise NotImplementedError(_TODO_SPARSE)
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
    bbox and grid resolution. Tiles whose chunks touch more than 256
    cells are counted in ``fallback_rays`` and left out."""
    _check_slice(field, tile_px, pitch, cell_scale, occupancy, quantize,
                 uniform_shape, all_tiles, bank_aligned)
    bbox_min = tuple(float(v) for v in field.bbox_min)
    bbox_max = tuple(float(v) for v in field.bbox_max)
    nz, ny, nx = (int(v) for v in field.sigma.shape[:3])
    check(min(nx, ny, nz) >= 2, "tiled rendering requires grid dims >= 2")

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

    tiles, sub_tile_ids = _tile_rays(plan)             # (n_tiles, 256)
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
    fallback_rays = 0
    tiled_samples = 0
    pad_pid_base = plan.width * plan.height
    inv_ext = [np.float32(1.0 / (bbox_max[i] - bbox_min[i]))
               if bbox_max[i] != bbox_min[i] else np.float32(0.0)
               for i in range(3)]
    nudge = np.nextafter(t_far, t_near, dtype=np.float32)
    lanes_per_row = RAYS_PER_TILE * CHUNK           # 2048 samples per chunk
    umax = 2 * MAX_CELLS + 1

    for nc in sorted(set(n_chunks_tile[tile_live & (n_chunks_tile > 0)])):
        sel = np.nonzero(tile_live & (n_chunks_tile == nc))[0]
        nc = int(nc)
        t_cnt = sel.size
        k_steps = nc * CHUNK

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
        cell = (iz * ny + iy) * nx + ix               # full-pitch table row

        def to_lanes(a):
            # (T, 256, K) -> (T, nc, 16, 128): ray = row * 16 + lane // 8
            a = a.reshape(t_cnt, 16, 16, nc, CHUNK)
            a = a.transpose(0, 3, 1, 2, 4)
            return a.reshape(t_cnt, nc, 16, 128)

        cell_l = to_lanes(np.where(m, cell, _SENTINEL))
        m_l = to_lanes(m.astype(np.float32))
        st_l = to_lanes(np.broadcast_to(
            sample_t, (t_cnt, RAYS_PER_TILE, k_steps)))
        flat = cell_l.reshape(t_cnt * nc, lanes_per_row)
        lidx, lanes_run, ucell, ulane, n_u = _pack_runs_numpy(flat, umax)

        rayt_all = np.stack(
            [ot[:, :, i].reshape(t_cnt, 2, 128) for i in range(3)]
            + [dtn[:, :, i].reshape(t_cnt, 2, 128) for i in range(3)],
            axis=1).astype(np.float32).reshape(t_cnt, 12, 128)

        # A tile with a chunk of more than 256 cells overflows: its rays
        # would need the windowed fallback.
        lanes2 = lanes_run.reshape(t_cnt, nc)
        overflow = (lanes2 > 2 * MAX_CELLS).any(axis=1)
        fallback_rays += int(live_r[overflow].sum())

        # Dense bank packing: each chunk's run lands at the next free lane;
        # runs of more than 128 cells start on a bank boundary. Empty runs
        # anchor at lane 0 (their samples are masked but must index a
        # valid lane).
        offs = np.zeros((t_cnt, nc), np.int64)
        cur = np.zeros(t_cnt, np.int64)
        for r in range(nc):
            n_c = lanes2[:, r].astype(np.int64)
            align = n_c > MAX_CELLS
            cur = np.where(align, -(-cur // MAX_CELLS) * MAX_CELLS, cur)
            offs[:, r] = np.where(n_c > 0, cur, 0)
            cur += n_c
        off = np.where(overflow[:, None], 0, offs)
        nb_tile = np.where(overflow, 0, np.maximum(-(-cur // MAX_CELLS), 1))

        for nb in sorted(set(nb_tile[~overflow].tolist())):
            keep = (~overflow) & (nb_tile == nb)
            nb = int(nb)
            lanes = nb * MAX_CELLS
            t_kept = int(keep.sum())
            rowsel = np.repeat(keep, nc)
            off_k = off[keep].reshape(-1)            # (t_kept * nc,)

            # Dead lanes (bank rounding, pad tiles, empty-run anchors) are
            # -1; the device gather reads row 0 for them.
            hostmap = np.full((t_kept, lanes), -1, np.int64)
            n_u_k = n_u[rowsel]
            ucell_k, ulane_k = ucell[rowsel], ulane[rowsel]
            rws, cls = np.nonzero(
                np.arange(ucell.shape[1])[None, :] < n_u_k[:, None])
            hostmap[rws // nc, off_k[rws] + ulane_k[rws, cls]] = \
                ucell_k[rws, cls]

            # Tile-local lanes; masked samples point at their run's start.
            rank_s = lidx.reshape(t_cnt, nc, lanes_per_row)[keep].astype(
                np.int64)
            m_k3 = m_l.reshape(t_cnt, nc, lanes_per_row)[keep] > 0
            off_bc = off[keep][:, :, None]
            nuq_bc = lanes2[keep][:, :, None]
            lidx_local = np.where(m_k3, off_bc + np.minimum(
                rank_s, np.maximum(nuq_bc - 1, 0)),
                off_bc).astype(np.int32).reshape(t_kept, nc, 16, 128)
            m_k = m_k3.reshape(t_kept, nc, 16, 128)

            check(nb <= 255, "bank space exceeds the 15-bit lane id")
            packed_bits = lidx_local | (m_k.astype(np.int32) << 15)
            st_bits = np.ascontiguousarray(st_l[keep]).view(np.uint32)
            samp = np.stack(
                [(st_bits >> 16).astype(np.uint16),
                 (st_bits & np.uint32(0xFFFF)).astype(np.uint16),
                 packed_bits.astype(np.uint16)],
                axis=2)                               # (T, nc, 3, 16, 128)

            # Per-lane cell base coordinates: the clipped floor indices,
            # recovered from the lane's cell id (dead lanes: cell 0).
            hm_c = np.maximum(hostmap, 0)
            iz_u = hm_c // (ny * nx)
            rem_u = hm_c % (ny * nx)
            base = np.stack([(rem_u % nx), (rem_u // nx), iz_u],
                            axis=1).astype(np.float32)    # (T, 3, lanes)
            base = base.reshape(t_kept, 3, nb, MAX_CELLS).transpose(
                0, 2, 1, 3)                               # (T, nb, 3, 128)
            rayt = rayt_all[keep]
            # ALIGNED bit (30): the chunk's run fits bank b0 alone. Only
            # the backward reads it; the forward masks it off.
            n_keep = lanes2[keep]
            fits = (n_keep > 0) & (off[keep] % MAX_CELLS + n_keep
                                   <= MAX_CELLS)
            bank0 = ((off[keep] // MAX_CELLS)
                     | (fits.astype(np.int64) << 30)).astype(np.int32)
            bank0 = bank0[:, :, None]                     # (T, nc, 1)

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
            uniq_r = hostmap.astype(np.int32)         # (T, lanes)
            ke_k = ke_t[keep].astype(np.int32)
            tile_ids_k = sub_tile_ids[sel][keep].astype(np.int32)
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
    return TiledSchedule(
        groups=tuple(groups), fallback=None,
        hostmap_all=hostmap_all, gathermap_all=hostmap_all,
        total_rays=n, tiled_samples=tiled_samples,
        full_lattice_samples=n * k_max, fallback_rays=fallback_rays,
        grid_shape=(nz, ny, nx), bbox=(bbox_min, bbox_max))


# --------------------------------------------------------------- device side


def _gather_bank_tables(table: torch.Tensor, gathermap_all: torch.Tensor,
                        group_shapes) -> tuple:
    """(R, 32) packed table -> per-group bank blocks (T, NB, 32, 128).

    Dead lanes (-1) read row 0, as the JAX gather's ``mode="clip"``
    does; torch indexing would wrap -1 to the last row."""
    rows = torch.index_select(table, 0, gathermap_all.clamp(min=0))
    banks = rows.reshape(-1, MAX_CELLS, NCH).transpose(1, 2).contiguous()
    out, off = [], 0
    for t_cnt, nb in group_shapes:
        out.append(banks[off:off + t_cnt * nb].reshape(
            t_cnt, nb, NCH, MAX_CELLS))
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


def _compose_tiles(plan: Plan, raws, tile_ids, fallback_parts=(),
                   tile_px: int = 16) -> ImagePlanes:
    """Place each (16, 16) output tile at its image region. Tiles with an
    id outside the ROI's tile grid (the pad sentinel 1 << 30) are dropped,
    as the JAX scatter's ``mode="drop"`` does. Rays that no tile renders
    keep the background (T = 1, depth = t_far)."""
    if fallback_parts:
        raise NotImplementedError(_TODO_FALLBACK)
    roi = plan.roi
    n_tiles = (-(-roi.width // tile_px)) * (-(-roi.height // tile_px))
    device = raws[0].device if raws else None
    tiles5 = torch.zeros((n_tiles, 5, tile_px, tile_px), dtype=torch.float32,
                         device=device)
    if raws:
        raw = raw_to_subtiles(torch.cat(raws), tile_px)
        ids = torch.cat([t.reshape(-1) for t in tile_ids]).long()
        keep = (ids >= 0) & (ids < n_tiles)
        tiles5[ids[keep]] = raw[keep]
    image, trans, opac, dep = tiles5_to_planes(plan, tiles5, tile_px)
    return ImagePlanes(image=image, transmittance=trans, opacity=opac,
                       depth=dep,
                       hitmask=windowed_mod.roi_hitmask(plan, image.device))


def render_tiled(plan: Plan, field, schedule: TiledSchedule,
                 use_kernel: bool = True) -> ImagePlanes:
    """Tile-table forward render of a dense field.

    The schedule must be on the field's device (:meth:`TiledSchedule.to`).
    ``use_kernel=False`` runs the plain PyTorch twins of K3 and K1 on
    that device: the reference the kernels are held to. Forward only: the
    backward kernels are ROADMAP Queue 1 item 8, so this refuses to run
    where autograd would record the field's parameters."""
    check(tuple(float(v) for v in field.bbox_min) == tuple(schedule.bbox[0])
          and tuple(float(v) for v in field.bbox_max)
          == tuple(schedule.bbox[1]),
          "schedule was built for a different field bbox (cell ids and "
          "fraction constants depend on it)")
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "tiled rendering requires an OOB_ZERO field")
    check(tuple(int(v) for v in field.sigma.shape[:3])
          == tuple(schedule.grid_shape),
          "schedule was built for a different grid resolution")
    if schedule.fallback_rays:
        raise NotImplementedError(
            f"{schedule.fallback_rays} rays need {_TODO_FALLBACK}")
    sigma, color = field.sigma, field.color
    if torch.is_grad_enabled() and (sigma.requires_grad
                                    or color.requires_grad):
        raise NotImplementedError(
            "the tiled backward is ROADMAP Queue 1 item 8: render under "
            "torch.no_grad()")
    check(schedule.device == sigma.device,
          f"schedule is on {schedule.device}, the field on {sigma.device}: "
          f"move it with schedule.to(device)")

    geom = (schedule.bbox[0], schedule.bbox[1], schedule.grid_shape)
    if use_kernel:
        table = packed_transpose.build_rows(sigma, color)
        forward = fused_tiles.tile_forward
    else:
        table = packed_transpose.build_rows_plain(sigma, color)
        forward = fused_tiles.tile_forward_plain
    tabs = _gather_bank_tables(
        table, schedule.gathermap_all,
        [(g.n_tiles, g.banks) for g in schedule.groups])
    raws = [
        forward(tabs[gi], g.samp, g.base, g.rayt, g.k_enter,
                g.bank0.reshape(-1),
                fused_tiles.tile_op_params(plan, geom, g.banks, g.n_chunks))
        for gi, g in enumerate(schedule.groups)]
    return _compose_tiles(plan, raws, [g.tile_ids for g in schedule.groups])
