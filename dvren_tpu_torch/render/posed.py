"""Device-built pose schedules: moving-camera rendering without a host build.

Counterpart of ``dvren_tpu/render/posed.py``. A tile schedule depends on
the camera, and the host build (:func:`~dvren_tpu_torch.render.tiled.
build_tiled_schedule`) costs seconds a pose. Under the camera-stable
contract (every image tile in one uniform group of ``nc_pin`` chunks and
``nb_pin`` banks) every array of the schedule has a shape fixed by the
plan's geometry, so :class:`PosedRenderer` builds it on the device from
the two camera arrays and renders it through
:func:`~dvren_tpu_torch.render.tiled.render_tiled` (K3, the bank gather,
one K1 launch over the pinned group, the compose).

On a CUDA field with ``use_kernel`` (the default) the build is raygen and
one launch of ``csrc/posed_build.cu``
(:func:`~dvren_tpu_torch.ops.posed_build.posed_build`: one block per
tile, every intermediate in registers and shared memory), which writes
every array of the schedule and the diagnostics. The torch build below
is its plain twin, equal to it bit for bit; the twin builds on the CPU,
under ``use_kernel=False``, and in the construction-time probe on every
device. The counter ``posed.kernel_frames`` (``utils/trace.py``) counts
the frames whose schedule the kernel built: each replay of a graph that
recorded it, each split-mode render.

Lanes come from the JAX package's closed-form sliced-box assignment: per
(tile, chunk) run the touched cells are sliced by z, each slice gets its
tight x / y box, and a sample's lane is

    lane = off + prefix[zrel] + (iy - y0[zrel]) * ex[zrel] + (ix - x0[zrel])

with ``prefix`` the running sum of the slice areas and ``off`` the host
packer's offset recurrence (runs over 128 lanes start at a bank). Given
the same ray planes, every array of the schedule (lane and mask words,
sample depths, hostmap, bank0, k_enter) and the pins and diagnostics
equal the JAX package's array for array, its build run op by op: the
same float32 arithmetic in the same order, each product and sum rounded
on its own (no FMA), as the host schedule build and the kernels round
them. (Under ``jax.jit`` XLA's CPU backend contracts a sample's position
``o + d * t`` into an FMA and fuses ``1 / sqrt`` of the ray directions;
where that moves a position across a cell boundary or the bbox, a lane
word of JAX's jitted schedule differs.) Where JAX runs a Python loop of
masked reductions per z-slice, the port's twin reduces once: the
per-slice boxes are ``scatter_reduce`` (``amin`` / ``amax``) keyed by
(tile, chunk, slice, lane) and reduced over the lanes, a sample's rank
gathers its slice's row, and the lane-to-cell decode finds each lane's
run by a running maximum of the run starts and its slice by a
``searchsorted`` of the slices' prefixes; the kernel takes each slice's
box with integer atomics in shared memory and decodes a lane by scanning
its tile's runs and slices there. All are exact integer operations, the
same in every run.

Modes (``fused``): on a CUDA field the default (None) is graph mode, the
counterpart of JAX's one fused dispatch on a TPU: build and render are
recorded once as one CUDA Graph (:mod:`dvren_tpu_torch.render.graph`)
and replayed per pose, with only the two camera arrays copied into the
graph's inputs. ``fused=False`` runs :meth:`PosedRenderer.schedule_for`
and then ``render_tiled`` eagerly (JAX's CPU mode); it is the default on
the CPU, where ``fused=True`` raises. The graph is keyed on the field's
parameters (address, shape, dtype, device): a new field object records a
new graph, an in-place edit of the same tensors replays.

Restrictions (checked at construction and at every render): a dense
float32 OOB_ZERO LINEAR field, a full-image ROI with width and height
multiples of 16, 16 px tiles, pitch 1, cell tables; forward only.

Two reference defects are not copied: JAX's ``render`` / ``render_sweep``
keep the field without re-running the construction checks, so a nearest,
clamp, 16-bit or sparse field would render as a linear one; and its
probe counts at most 32 z-slices a run (``_run_stats(..., ez=32)``),
which undercounts the lanes and banks of a run that spans more. The port
checks the field at every call and probes with the exact slice count.
"""

from __future__ import annotations

import numpy as np
import torch

from dvren_tpu_torch.core.plan import InterpMode, OobPolicy, Plan
from dvren_tpu_torch.core.status import DvrenError, check
from dvren_tpu_torch.ops.fused_tiles import DESC_WORDS, TileSet
from dvren_tpu_torch.ops.posed_build import posed_build
from dvren_tpu_torch.ops.raygen import generate_rays
from dvren_tpu_torch.render import graph as graph_mod
from dvren_tpu_torch.render.pipeline import plan_jitter_table
from dvren_tpu_torch.render.tiled import (CHUNK, MAX_CELLS, TiledSchedule,
                                          TileGroup, _tile_rays,
                                          render_tiled)
from dvren_tpu_torch.utils import trace

_BIG = 1 << 30


def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float (exact in torch's
    float32 arithmetic with a scalar)."""
    return float(np.float32(v))


def _plan_geometry(plan: Plan) -> tuple:
    roi = plan.roi
    return (plan.width, plan.height, float(plan.t_near),
            float(plan.t_far), float(plan.sampling.dt),
            int(plan.sampling.max_steps), int(plan.sampling.mode),
            int(plan.seed), (roi.x, roi.y, roi.width, roi.height),
            int(plan.camera.model))


def _tiles_transpose(a, ty_n: int, tx_n: int):
    """(..., H*W) row-major rays -> (..., T, 256) tile-major (16x16 blocks,
    row-major within a block); numpy arrays or tensors."""
    lead = tuple(a.shape[:-1])
    a = a.reshape(lead + (ty_n, 16, tx_n, 16))
    perm = tuple(range(len(lead))) + tuple(len(lead) + i
                                           for i in (0, 2, 1, 3))
    a = a.transpose(perm) if isinstance(a, np.ndarray) else a.permute(perm)
    return a.reshape(lead + (ty_n * tx_n, 256))


def _rays_to_lanes(a: torch.Tensor) -> torch.Tensor:
    """(T, 256) per-ray -> (T, 16, 128) sample layout (ray = row * 16 +
    lane // 8; every ray value repeated over its 8 step lanes)."""
    t = a.shape[0]
    return a.reshape(t, 16, 16, 1).expand(t, 16, 16, CHUNK).reshape(
        t, 16, 128)


def _check_field(field) -> None:
    """The field constraints of posed rendering (JAX's construction-time
    checks, run here at every call)."""
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "posed rendering requires an OOB_ZERO field")
    check(getattr(field, "interp", InterpMode.LINEAR) == InterpMode.LINEAR,
          "posed rendering requires LINEAR interpolation")
    sigma = getattr(field, "sigma", None)
    check(not hasattr(field, "bricks") and sigma is not None
          and sigma.dim() == 3 and hasattr(field, "color")
          and getattr(field, "packed_dtype", "float32") == "float32",
          "posed rendering supports dense float32 grids")


def _u16(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65536) -> the same bits as uint16."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16).view(
        torch.uint16)


class PosedRenderer:
    """Renders any camera pose of ``base_plan``'s geometry; the tile
    schedule is built on the field's device (module docstring).

    >>> r = PosedRenderer(plan0, field)
    >>> planes = r.render(plan_for(pose), field)

    ``nc_pin`` / ``nb_pin`` / ``ez_pin`` pin the uniform chunk count, bank
    count and the z-slices a run may span; by default a probe at the base
    pose (and at ``probe_plans``, the pins taking the largest need) plus
    ``headroom``. A pose that exceeds a pin raises on the next
    :meth:`check_ok` or :meth:`render` (re-create with larger pins).
    ``use_kernel=False`` renders through the kernels' plain twins.
    ``fused``: None for graph mode on a CUDA field and the split mode on
    the CPU, False for the split mode, True for graph mode (a CUDA field
    only). Traced (``utils/trace.py``): the construction as the span
    ``posed.setup``, its probe as ``posed.probe``."""

    @trace.spanned("posed.setup")
    def __init__(self, base_plan: Plan, field, nc_pin=None, nb_pin=None,
                 ez_pin=None, headroom=(1, 2, 2), use_kernel: bool = True,
                 fused: bool | None = None, probe_plans=None):
        _check_field(field)
        roi = base_plan.roi
        check(roi.x == 0 and roi.y == 0 and roi.width == base_plan.width
              and roi.height == base_plan.height
              and roi.width % 16 == 0 and roi.height % 16 == 0,
              "posed rendering requires a full-image ROI with "
              "width/height multiples of 16")
        self._geom = _plan_geometry(base_plan)
        self._plan = base_plan
        self._use_kernel = use_kernel
        self._device = field.sigma.device
        self._grid = tuple(int(v) for v in field.sigma.shape[:3])
        self._bbox = (tuple(float(v) for v in field.bbox_min),
                      tuple(float(v) for v in field.bbox_max))
        nz, ny, nx = self._grid
        check(min(nx, ny, nz) >= 2, "grids must have dims >= 2")
        self._ty_n = roi.height // 16
        self._tx_n = roi.width // 16
        self._t_cnt = self._ty_n * self._tx_n
        check(self._t_cnt % 8 == 0,
              "posed rendering needs a tile count divisible by 8 "
              "(kernel DMA blocks); use images >= 128 px on one side")
        k_max = base_plan.sampling.max_steps
        check(k_max % CHUNK == 0,
              "posed rendering requires max_steps % 8 == 0")
        if fused is None:
            fused = self._device.type == "cuda"
        if fused and self._device.type != "cuda":
            raise DvrenError.unsupported(
                f"PosedRenderer(fused=True) records a CUDA graph; the field "
                f"is on the CPU ({self._device}): use fused=False there")
        self._fused = bool(fused)

        # camera-independent constants, built once on the device
        dev = self._device
        tiles, sub_ids = _tile_rays(base_plan, 16)
        ref = _tiles_transpose(np.arange(roi.width * roi.height,
                                         dtype=np.int64)[None],
                               self._ty_n, self._tx_n)[0]
        assert (tiles == ref).all(), "tile layout mismatch"

        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self._tile_ids = upload(sub_ids.astype(np.int32))
        self._pixel_ids = upload(tiles.reshape(-1).astype(np.int32))
        self._ray_ids = upload(tiles.astype(np.int32))
        jt = plan_jitter_table(base_plan)
        self._jt_k = None
        if jt is not None:
            # tile-major, k-major jitter (T, K, 256): camera-independent
            jt = np.asarray(jt, np.float32)[:, :k_max]
            jtt = _tiles_transpose(np.ascontiguousarray(jt.T), self._ty_n,
                                   self._tx_n)               # (K, T, 256)
            self._jt_k = upload(jtt.transpose(1, 0, 2))      # (T, K, 256)

        if nc_pin is None or nb_pin is None or ez_pin is None:
            with trace.span("posed.probe"):
                stats = np.stack([
                    self._probe_stats(*self._cam_arrays(p)).cpu().numpy()
                    for p in [base_plan] + list(probe_plans or [])]).max(0)
            span_c, run_max, ez_max, nb_need = (int(v) for v in stats)
            check(run_max <= 2 * MAX_CELLS,
                  f"sliced-box run exceeds 2 banks at the base pose "
                  f"({run_max} cells): scene too coarse for the posed "
                  f"path (use finer tiles via the host-built schedule)")
            nc_pin = (min(span_c + int(headroom[0]), k_max // CHUNK)
                      if nc_pin is None else nc_pin)
            nb_pin = nb_need + int(headroom[1]) if nb_pin is None else nb_pin
            ez_pin = ez_max + int(headroom[2]) if ez_pin is None else ez_pin
        self.nc_pin = int(nc_pin)
        self.nb_pin = int(nb_pin)
        self.ez_pin = int(ez_pin)
        check(self.nb_pin <= 255, "bank space exceeds the 15-bit lane id")

        # the one-launch descriptor of the pinned group: a function of the
        # pins alone (fused_tiles.tile_set's layout for one shape)
        t, nc, nb = self._t_cnt, self.nc_pin, self.nb_pin
        desc = np.empty((t, DESC_WORDS), np.int32)
        desc[:, 0], desc[:, 1] = nc, nb
        desc[:, 2] = nc * np.arange(t)
        desc[:, 3] = nb * np.arange(t)
        self._desc = upload(desc)
        self._order = upload(np.arange(t, dtype=np.int32))

        self._graph = None        # (key, CapturedGraph) in graph mode
        self._captures = 0
        self._cam = None          # the graph's static camera inputs
        self._last_diag = None
        self._frames = 0          # frames rendered (a trace's unit)

    # ------------------------------------------------------------------
    def _cam_arrays(self, plan: Plan):
        """(K (3, 3), c2w with the orthographic scale as row 3 (4, 4)),
        float32 on the device."""
        k = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
        c2w = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
        s = np.full((1, 4), np.float32(plan.camera.ortho_scale))
        cam = (k, np.concatenate([c2w, s], axis=0))
        return tuple(torch.from_numpy(a).to(self._device) for a in cam)

    def _tile_rays_planes(self, k, c2w):
        """Device raygen -> per-axis (T, 256) origin / direction planes."""
        rays = generate_rays(self._plan, k=k, c2w=c2w[:3],
                             ortho_scale=c2w[3, 0])
        o = [_tiles_transpose(rays.origins[:, i][None], self._ty_n,
                              self._tx_n)[0] for i in range(3)]
        d = [_tiles_transpose(rays.directions[:, i][None], self._ty_n,
                              self._tx_n)[0] for i in range(3)]
        return o, d

    def _lattice_consts(self):
        p = self._plan
        nz, ny, nx = self._grid
        lo, hi = self._bbox
        inv = [_f32(1.0 / (hi[i] - lo[i])) if hi[i] != lo[i] else 0.0
               for i in range(3)]
        nudge = float(np.nextafter(np.float32(p.t_far),
                                   np.float32(p.t_near), dtype=np.float32))
        return (_f32(p.t_near), _f32(p.t_far), _f32(p.sampling.dt), nudge,
                [_f32(v) for v in lo], inv, (nx, ny, nz))

    def _mask_full(self, o, d, jt_k):
        """Pass A: the exact in-bbox sample mask over the full lattice,
        (T, K, 256) layout -> per-tile window start and span (tke, span)."""
        K = self._plan.sampling.max_steps
        dev = self._device
        t_near, t_far, dt, nudge, lo, inv, _ = self._lattice_consts()
        kf = torch.arange(K, dtype=torch.float32, device=dev)[None, :, None]
        base_t = t_near + kf * dt
        jt = 0.5 if jt_k is None else jt_k
        st = base_t + jt * dt
        st = torch.where(st >= t_far, nudge, st)
        m = (base_t < t_far).expand(st.shape)
        for ax in range(3):
            pos = o[ax][:, None, :] + d[ax][:, None, :] * st
            local = (pos - lo[ax]) * inv[ax]
            m = m & (local >= 0.0) & (local <= 1.0)
        kidx = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None]
        tke = torch.where(m, kidx, _BIG).amin(dim=(1, 2))
        klast = torch.where(m, kidx, -1).amax(dim=(1, 2))
        tke = torch.where(klast >= 0, tke, 0).to(torch.int32)
        span = torch.clamp(klast + 1 - tke, min=0).to(torch.int32)
        return tke, span

    def _window_lattice(self, o, d, tke, nc: int, jt_k):
        """Pass B: sample depth, cell indices and mask in the kernel's
        (T, nc, 16, 128) window layout (chunk boundaries at tke)."""
        K = self._plan.sampling.max_steps
        T = self._t_cnt
        dev = self._device
        t_near, t_far, dt, nudge, lo, inv, (nx, ny, nz) = \
            self._lattice_consts()
        nc8 = nc * CHUNK
        if jt_k is None:
            jw = torch.full((T, nc, 16, 128), 0.5, dtype=torch.float32,
                            device=dev)
        else:
            # the rows [tke, tke + nc8) of each tile's table, zero past K
            idx = tke.to(torch.int64)[:, None] + torch.arange(
                nc8, dtype=torch.int64, device=dev)[None, :]
            g = torch.gather(jt_k, 1, idx.clamp(max=K - 1)[:, :, None]
                             .expand(T, nc8, 256))
            jw = torch.where((idx < K)[:, :, None], g, 0.0)
            jw = jw.reshape(T, nc, CHUNK, 16, 16).permute(
                0, 1, 3, 4, 2).reshape(T, nc, 16, 128)
        j_in = torch.arange(128, dtype=torch.int32,
                            device=dev)[None, None, None, :] % CHUNK
        c_of = (torch.arange(nc, dtype=torch.int32, device=dev)
                * CHUNK)[None, :, None, None]
        kw = tke[:, None, None, None] + c_of + j_in      # (T, nc, 1, 128)
        base_t = t_near + kw.to(torch.float32) * dt
        st = base_t + jw * dt
        st = torch.where(st >= t_far, nudge, st)
        m = (base_t < t_far) & (kw < K)
        idx = []
        for ax, npts in ((0, nx), (1, ny), (2, nz)):
            o_s = _rays_to_lanes(o[ax])[:, None]
            d_s = _rays_to_lanes(d[ax])[:, None]
            pos = o_s + d_s * st
            local = (pos - lo[ax]) * inv[ax]
            m = m & (local >= 0.0) & (local <= 1.0)
            f = local * float(npts - 1)
            idx.append(torch.clamp(torch.floor(f), 0, npts - 2)
                       .to(torch.int32))
        return st, idx[0], idx[1], idx[2], m

    def _probe_stats(self, k, c2w):
        """Construction-time probe at full-lattice chunking: (window span
        chunks, max run lanes, max z-slices, banks needed), int32 (4,).
        The slices are counted exactly (JAX stops at 32)."""
        o, d = self._tile_rays_planes(k, c2w)
        tke, span = self._mask_full(o, d, self._jt_k)
        K = self._plan.sampling.max_steps
        _, ix, iy, iz, m = self._window_lattice(
            o, d, torch.zeros_like(tke), K // CHUNK, self._jt_k)
        _, _, _, run_lanes, ez_max = self._run_stats(ix, iy, iz, m, None)
        cur, _ = self._pack_offsets(run_lanes)
        return torch.stack([((span + CHUNK - 1) // CHUNK).max(),
                            run_lanes.max(), ez_max,
                            ((cur + MAX_CELLS - 1) // MAX_CELLS).max()]
                           ).to(torch.int32)

    def _run_stats(self, ix, iy, iz, m, ez):
        """Per-(tile, chunk) sliced-box stats: z0 (T, nc); per slice x0,
        y0, ex, area and the exclusive lane prefix (T, nc, ez); zrel (the
        sample's slice); run lanes (T, nc); the largest slice count (0-d).
        ``ez`` None counts every slice (read to the host: the probe)."""
        T, nc = int(m.shape[0]), int(m.shape[1])
        dev = self._device
        z0 = torch.where(m, iz, _BIG).amin(dim=(2, 3))
        z0 = torch.where(z0 == _BIG, 0, z0)                      # (T, nc)
        zrel = torch.where(m, iz - z0[:, :, None, None], 0)
        ez_max = (torch.where(m, zrel, -1).amax() + 1).to(torch.int32)
        if ez is None:
            ez = max(int(ez_max), 1)
        # the sample's (tile, chunk, slice) bin, one per lane of the chunk
        # (a bin's 2048 samples would otherwise contend for one address:
        # a lane's 16 samples are 16 rays at one step), reduced over the
        # lanes after the scatter; samples in no slice below ez land in a
        # dump bin past the end
        n_bins = T * nc * ez
        run = torch.arange(T * nc, dtype=torch.int64,
                           device=dev).reshape(T, nc, 1, 1)
        lane = torch.arange(128, dtype=torch.int64, device=dev)
        key = torch.where(m & (zrel < ez), run * ez + zrel, n_bins)
        key = (key * 128 + lane).reshape(-1)

        def per_slice(vals, how, init):
            out = torch.full(((n_bins + 1) * 128,), init, dtype=torch.int32,
                             device=dev)
            out.scatter_reduce_(0, key, vals.reshape(-1), reduce=how,
                                include_self=True)
            out = out.view(n_bins + 1, 128)
            out = out.amin(dim=1) if how == "amin" else out.amax(dim=1)
            return out[:n_bins].reshape(T, nc, ez)

        x0 = per_slice(ix, "amin", _BIG)
        x1 = per_slice(ix, "amax", -1)
        y0 = per_slice(iy, "amin", _BIG)
        y1 = per_slice(iy, "amax", -1)
        ex = torch.clamp(x1 - x0 + 1, min=0)
        ey = torch.clamp(y1 - y0 + 1, min=0)
        x0s = torch.where(ex > 0, x0, 0)
        y0s = torch.where(ey > 0, y0, 0)
        areas = ex * ey
        prefix = torch.cumsum(areas, dim=-1, dtype=torch.int32) - areas
        run_lanes = areas.sum(dim=-1, dtype=torch.int32)          # (T, nc)
        return z0, (x0s, y0s, ex, areas, prefix), zrel, run_lanes, ez_max

    @staticmethod
    def _pack_offsets(run_lanes):
        """The host packer's lane-offset recurrence: runs over 128 lanes
        start at a bank boundary; empty runs anchor at 0. Returns the lanes
        used (T,) and each run's offset (T, nc)."""
        cur = torch.zeros_like(run_lanes[:, 0])
        offs = []
        for c in range(int(run_lanes.shape[1])):
            n = run_lanes[:, c]
            cur = torch.where(n > MAX_CELLS,
                              (cur + MAX_CELLS - 1) // MAX_CELLS * MAX_CELLS,
                              cur)
            offs.append(torch.where(n > 0, cur, 0))
            cur = cur + n
        return cur, torch.stack(offs, dim=-1)

    def _decode_lanes(self, off, run_lanes, z0, boxes, ez: int):
        """The lane -> cell decode: per tile lane, the run that holds it
        (the last run start at or before it), its slice (the last slice
        whose prefix is at or below its rank in the run) and the cell;
        (0, 0, 0) on a lane no run uses. Returns (ix, iy, iz) (T, lanes)."""
        x0s, y0s, exs, areas, prefix = boxes
        T, nc = int(off.shape[0]), int(off.shape[1])
        lanes = self.nb_pin * MAX_CELLS
        dev = self._device
        lane = torch.arange(lanes, dtype=torch.int32, device=dev)[None, :]
        # each non-empty run's start marked with its chunk index
        pos = torch.where((run_lanes > 0) & (off < lanes), off, lanes)
        chunk = torch.arange(nc, dtype=torch.int32, device=dev).expand(T, nc)
        starts = torch.full((T, lanes + 1), -1, dtype=torch.int32,
                            device=dev)
        starts.scatter_reduce_(1, pos.to(torch.int64), chunk, reduce="amax",
                               include_self=True)
        c_of = torch.cummax(starts[:, :lanes], dim=1).values   # (T, lanes)
        c_safe = c_of.clamp(min=0).to(torch.int64)
        off_c = torch.gather(off, 1, c_safe)
        in_run = (c_of >= 0) & (lane < off_c + torch.gather(run_lanes, 1,
                                                             c_safe))
        r_in = lane - off_c
        # the slice: the flat (tile, chunk, slice) rows' keys rise with
        # (tile, chunk) and, within one, with the prefix
        run = (torch.arange(T, dtype=torch.int64, device=dev)[:, None] * nc
               + c_safe)                                       # (T, lanes)
        keys = ((torch.arange(T * nc, dtype=torch.int64,
                              device=dev)[:, None] << 32)
                + prefix.reshape(T * nc, ez).to(torch.int64)).reshape(-1)
        q = (run << 32) + r_in.clamp(min=0).to(torch.int64)
        row = torch.searchsorted(keys, q.reshape(-1), right=True) - 1
        row = row.reshape(T, lanes)

        def at(tab):
            return tab.reshape(-1)[row]

        a_s, p_s = at(areas), at(prefix)
        sel = in_run & (a_s > 0) & (r_in >= p_s) & (r_in < p_s + a_s)
        q_s = r_in - p_s
        e_s = torch.clamp(at(exs), min=1)
        gx = at(x0s) + q_s % e_s
        gy = at(y0s) + q_s // e_s
        gz = z0.reshape(-1)[run] + (row - run * ez).to(torch.int32)
        return tuple(torch.where(sel, g, 0).to(torch.int32)
                     for g in (gx, gy, gz))

    # ------------------------------------------------------------------
    @property
    def kernel_build(self) -> bool:
        """Whether the schedule comes from the build kernel
        (``csrc/posed_build.cu``): a CUDA field with ``use_kernel``; else
        the torch twin builds it."""
        return self._use_kernel and self._device.type == "cuda"

    def _build_schedule(self, k, c2w):
        """The device schedule build: (one-group TiledSchedule, diagnostics
        (4,) int32 [span chunks, max run, max z-slices, banks needed]).
        One kernel launch where :attr:`kernel_build`, else the torch
        twin."""
        if self.kernel_build:
            return self._build_schedule_kernel(k, c2w)
        nc, nb, ez = self.nc_pin, self.nb_pin, self.ez_pin
        T = self._t_cnt
        nz, ny, nx = self._grid
        jt_k = self._jt_k
        trace.stage("raygen")
        o, d = self._tile_rays_planes(k, c2w)
        trace.stage("mask")
        tke, span = self._mask_full(o, d, jt_k)
        trace.stage("lattice")
        st, ix, iy, iz, m = self._window_lattice(o, d, tke, nc, jt_k)
        trace.stage("run_stats")
        z0, boxes, zrel, run_lanes, ez_max = self._run_stats(ix, iy, iz, m,
                                                             ez)
        x0s, y0s, exs, areas, prefix = boxes
        trace.stage("lanes")
        cur, off = self._pack_offsets(run_lanes)
        diag = torch.stack([((span + CHUNK - 1) // CHUNK).max(),
                            run_lanes.max(), ez_max,
                            ((cur + MAX_CELLS - 1) // MAX_CELLS).max()]
                           ).to(torch.int32)

        # each sample's lane rank in its run: its slice's row of the stats
        s_idx = zrel.clamp(max=ez - 1).reshape(T, nc, -1).to(torch.int64)

        def at(tab):
            return torch.gather(tab, 2, s_idx).reshape(ix.shape)

        r_s = at(prefix) + (iy - at(y0s)) * at(exs) + (ix - at(x0s))
        rank = torch.where(m & (zrel < ez), r_s, 0)
        off4 = off[:, :, None, None]
        lidx = torch.where(m, off4 + rank, off4).to(torch.int32)

        # slim samp pack: [st hi16, st lo16, lane | mask << 15]
        bits = st.contiguous().view(torch.int32)
        packed = (lidx | (m.to(torch.int32) << 15)) & 0xFFFF
        samp = _u16(torch.stack([(bits >> 16) & 0xFFFF, bits & 0xFFFF,
                                 packed], dim=2))      # (T, nc, 3, 16, 128)

        cell_ix, cell_iy, cell_iz = self._decode_lanes(off, run_lanes, z0,
                                                       boxes, ez)
        hostmap = ((cell_iz * ny + cell_iy) * nx + cell_ix).to(torch.int32)
        base = torch.stack([cell_ix, cell_iy, cell_iz], dim=1).to(
            torch.float32).reshape(T, 3, nb, MAX_CELLS).permute(
                0, 2, 1, 3).contiguous()                 # (T, nb, 3, 128)
        rayt = torch.stack([o[i].reshape(T, 2, 128) for i in range(3)]
                           + [d[i].reshape(T, 2, 128) for i in range(3)],
                           dim=1).reshape(T, 12, 128)
        # a pose within its pins has off < nb * 128; past them, the clamp
        # keeps every bank read inside the tile's banks (the diagnostics
        # then refuse the frame)
        bank0 = torch.clamp(off // MAX_CELLS, max=nb - 1).to(
            torch.int32)[:, :, None]
        return self._schedule(samp, base, rayt, bank0, tke,
                              hostmap.reshape(-1)), diag

    def _build_schedule_kernel(self, k, c2w):
        """:meth:`_build_schedule` on the card: raygen, then one launch of
        ``csrc/posed_build.cu`` for every array and the diagnostics."""
        trace.stage("raygen")
        rays = generate_rays(self._plan, k=k, c2w=c2w[:3],
                             ortho_scale=c2w[3, 0])
        trace.stage("build")
        t_near, t_far, dt, nudge, lo, inv, _ = self._lattice_consts()
        samp, base, rayt, bank0, tke, hostmap, diag = posed_build(
            rays.origins, rays.directions, self._jt_k, tiles_x=self._tx_n,
            n_tiles=self._t_cnt, k_max=self._plan.sampling.max_steps,
            nc=self.nc_pin, nb=self.nb_pin, ez=self.ez_pin, grid=self._grid,
            consts=(t_near, t_far, dt, nudge, lo, inv))
        return self._schedule(samp, base, rayt, bank0, tke, hostmap), diag

    def _schedule(self, samp, base, rayt, bank0, tke, hm_flat):
        """The one-group TiledSchedule over the build's arrays."""
        T, nc, nb = self._t_cnt, self.nc_pin, self.nb_pin
        nz, ny, nx = self._grid
        group = TileGroup(
            n_chunks=nc, n_tiles=T, banks=nb, hostmap=hm_flat,
            gathermap=hm_flat, samp=samp, base=base, rayt=rayt, bank0=bank0,
            ray_ids=self._ray_ids, k_enter=tke, pixel_ids=self._pixel_ids,
            tile_ids=self._tile_ids, samples=0)
        tiles = TileSet(
            shapes=((T, nc, nb),), subs=1,
            samp=samp.reshape(T * nc, 3, 16, 128),
            base=base.reshape(T * nb, 3, MAX_CELLS), rayt=rayt, ke=tke,
            bank0=bank0.reshape(-1), desc=self._desc, order=self._order)
        return TiledSchedule(
            groups=(group,), fallback=None, hostmap_all=hm_flat,
            gathermap_all=hm_flat, gather_plan=None,
            total_rays=self._plan.ray_count, tiled_samples=0,
            full_lattice_samples=(self._plan.ray_count
                                  * self._plan.sampling.max_steps),
            fallback_rays=0, grid_shape=(nz, ny, nx), bbox=self._bbox,
            tile_px=16, table_kind="dense", pitch=1,
            cell_scale=1).with_tiles(tiles)

    def _build_and_render(self, field, k, c2w):
        """Build and render, one pose: (planes, diagnostics)."""
        sched, diag = self._build_schedule(k, c2w)
        planes = render_tiled(self._plan, field, sched,
                              use_kernel=self._use_kernel)
        return planes, diag

    # ------------------------------------------------------------------
    def _check_plan(self, plan: Plan) -> None:
        check(_plan_geometry(plan) == self._geom,
              "PosedRenderer: plan differs from the base plan beyond "
              "the camera (re-create the renderer)")

    def _check_render_field(self, field) -> None:
        _check_field(field)
        check(tuple(float(v) for v in field.bbox_min) == self._bbox[0]
              and tuple(float(v) for v in field.bbox_max) == self._bbox[1]
              and tuple(int(v) for v in field.sigma.shape[:3]) == self._grid,
              "field geometry differs from the renderer's")
        check(field.sigma.device == self._device,
              f"the field is on {field.sigma.device}, the renderer on "
              f"{self._device}")

    def schedule_for(self, plan: Plan):
        """The device-built schedule for ``plan``'s camera (diagnostics
        checked). :meth:`render` builds it inside the render instead."""
        self._check_plan(plan)
        with torch.no_grad():
            sched, diag = self._build_schedule(*self._cam_arrays(plan))
        self._check_diag(diag)
        return sched

    def _check_diag(self, diag) -> None:
        span_c, run_max, ez_max, nb_need = (
            int(v) for v in torch.as_tensor(diag).cpu().reshape(-1))
        check(span_c <= self.nc_pin,
              f"pose needs {span_c} chunks > nc_pin={self.nc_pin}; "
              "re-create the PosedRenderer with a larger nc_pin")
        check(run_max <= 2 * MAX_CELLS,
              f"sliced-box run of {run_max} cells exceeds the kernel's "
              "2-bank window; use the host-built path for this pose")
        check(ez_max <= self.ez_pin,
              f"pose spans {ez_max} z-slices > ez_pin={self.ez_pin}; "
              "re-create the PosedRenderer with a larger ez_pin")
        check(nb_need <= self.nb_pin,
              f"pose needs {nb_need} banks > nb_pin={self.nb_pin}; "
              "re-create the PosedRenderer with a larger nb_pin")

    def _load_camera(self, plan: Plan, field) -> tuple:
        """Graph mode: copy ``plan``'s camera into the graph's inputs;
        returns the key of the graph that renders ``field``."""
        k, c2w = self._cam_arrays(plan)
        if self._cam is None:
            self._cam = (torch.empty_like(k), torch.empty_like(c2w))
        self._cam[0].copy_(k)
        self._cam[1].copy_(c2w)
        return graph_mod.tensor_key(field.sigma, field.color)

    def _replay(self, key: tuple, field):
        """Graph mode: replay the graph keyed ``key`` (recording it first
        for a new field) over the loaded camera; returns copies of
        (planes, diagnostics)."""
        if self._graph is None or self._graph[0] != key:
            self._graph = None        # free the old graph's buffers first

            def build_and_render():
                with torch.no_grad():
                    return self._build_and_render(field, *self._cam)

            self._graph = (key, graph_mod.capture(
                build_and_render, self._device).owned_by("posed.render"))
            self._captures += 1
        out = self._graph[1].replay()
        if self.kernel_build:
            trace.count("posed.kernel_frames")
        with trace.span("posed.clone"):
            return graph_mod.clone_outputs(out)

    def render(self, plan: Plan, field, check_diag: bool = True):
        """ImagePlanes for ``plan``'s camera: the device build and the
        render (one graph replay in graph mode).

        ``check_diag=False`` skips reading the diagnostics after the
        render (call :meth:`check_ok` after a sweep instead; the last
        frame's are kept). Traced (``utils/trace.py``) as the span
        ``posed.render``, the frame's number its unit, over
        ``posed.prepare`` (the checks and the camera's upload),
        ``graph.replay``, ``posed.clone`` and ``posed.check_diag``; the
        build's stages are ``raygen`` and ``build`` (the kernel) where
        :attr:`kernel_build`, else the twin's ``raygen``, ``mask``,
        ``lattice``, ``run_stats`` and ``lanes``, then the tiled render's.
        The counter ``posed.kernel_frames`` counts the frames whose
        schedule the kernel built."""
        with trace.span("posed.render", unit=self._frames):
            self._frames += 1
            with trace.span("posed.prepare"):
                self._check_plan(plan)
                self._check_render_field(field)
                key = self._load_camera(plan, field) if self._fused else None
            if self._fused:
                planes, diag = self._replay(key, field)
            else:
                with torch.no_grad(), trace.clock("posed.render",
                                                  self._device):
                    planes, diag = self._build_and_render(
                        field, *self._cam_arrays(plan))
                if self.kernel_build:
                    trace.count("posed.kernel_frames")
            self._last_diag = diag
            if check_diag:
                with trace.span("posed.check_diag"):
                    self._check_diag(diag)
        return planes

    def render_sweep(self, plans, field, check_diag: bool = True):
        """Render a pose sweep: one graph replay per pose. Returns (images
        (F, H, W, 3), diagnostics (F, 4)). Graph mode only, as JAX's sweep
        is TPU-only."""
        check(self._fused, "render_sweep needs fused mode (a CUDA graph)")
        for p in plans:
            self._check_plan(p)
        self._check_render_field(field)
        images, diags = [], []
        for p in plans:
            planes, diag = self._replay(self._load_camera(p, field), field)
            images.append(planes.image)
            diags.append(diag)
        images, diags = torch.stack(images), torch.stack(diags)
        self._last_diag = diags.max(dim=0).values
        if check_diag:
            self._check_diag(self._last_diag)
        return images, diags

    def check_ok(self) -> None:
        """Check the most recent frame's pin diagnostics (raises on a
        violation)."""
        if self._last_diag is not None:
            self._check_diag(self._last_diag)

    def cache_size(self) -> int:
        """Graphs recorded so far (1 after the first frame in graph mode
        while the field keeps its tensors; 0 in the split mode)."""
        return self._captures

    @property
    def captured(self):
        """The current :class:`~dvren_tpu_torch.render.graph.CapturedGraph`
        (None before the first graph-mode frame)."""
        return None if self._graph is None else self._graph[1]
