"""NGP-scale hash grid path: the host-resolved multi-level corner table,
and the fused hash-grid forward (K8f) and backward (K8b).

Counterpart of ``dvren_tpu/ops/hash_grid.py``. The in-kernel hash path
(:mod:`dvren_tpu_torch.ops.hash_tiles`) stops at table_size 128; Instant-
NGP tables (T >= 2^12) go through the dense path's bank machinery
instead:

- :func:`build_hash_grid_table`: the hash table (L, T, F) becomes one
  packed row per finest-level cell holding every level's 8 corner
  features (C = L*8*F columns, column (l*8 + corner)*F + f). The vertex
  hashes are static per spec, so the build is one gather;
  :func:`hash_grid_table_grad` is its adjoint, without a scatter: cells
  to level vertices by block sums and one-step shifted adds, vertices to
  table entries through a host plan of exact-count classes (the dense
  path's gather plan, :mod:`dvren_tpu_torch.ops.gather_plan`).
- The tile scheduler packs those cells into bank tables as for a dense
  grid over the finest level's point lattice (:func:`grid_shape`).
- K8f (``csrc/hash_grid.cu``) recomputes each level's trilinear weights
  from the sample position: with a power-of-two resolution ladder the
  level-l fraction is ``fs * r - floor(base * r)`` with the exact ratio
  ``r = res_l / res_finest``, so the 8 stored corners per level are the
  corners trilinear needs. It runs both MLP heads from the packed scalar
  vector, zeroes masked samples (the field is zero outside the unit
  cube) and integrates with exact early stop. K8b
  (``csrc/hash_grid_bwd.cu``) is its recompute adjoint: d(bank table)
  as f32 slot rows (T, NB, 128, C) and per-tile MLP partials.

:func:`hash_grid_forward` and :func:`hash_grid_backward` launch their
kernels for CUDA tensors and run the plain twins
(:func:`hash_grid_forward_plain`, :func:`hash_grid_backward_plain`) for
CPU tensors; their ``.launches`` attributes count launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.ops.fused_tiles import (CHUNK_SAMPLES, GROUP, LANES,
                                             RAYS_COLS, RAYS_PER_TILE,
                                             RAYT_ROWS, ROWS, _Lattice,
                                             _tie, corner_weights,
                                             march_plain)
from dvren_tpu_torch.ops.gather_plan import (build_gather_plan,
                                             slot_rows_to_table)
from dvren_tpu_torch.ops.grid import fullpitch_rows
from dvren_tpu_torch.ops.hash_tiles import (MLP_KEYS, _mlp_from_scalars,
                                            _mlp_layout)
from dvren_tpu_torch.ops.hashmlp import (_PRIME_Y, _PRIME_Z, HashMLPSpec,
                                         heads_from_planes,
                                         level_resolutions)
from dvren_tpu_torch.ops.integrate import STOP_THRESHOLD


def grid_path_ok(spec: HashMLPSpec) -> bool:
    """True when the grid path can carry this spec: explicit integer
    resolutions forming a power-of-two ladder with finest <= 64,
    hidden_dim <= 8 and encoding_dim <= 64 (any table_size: the build
    hashes with ``% T``)."""
    if spec.resolutions is None:
        return False
    res = list(spec.resolutions)
    if len(res) != spec.n_levels:
        return False
    ints = [int(r) for r in res]
    if any(float(r) != float(i) or i < 1 for r, i in zip(res, ints)):
        return False
    rf = ints[-1]
    if rf > 64:
        return False
    for r in ints:
        if rf % r or ((rf // r) & (rf // r - 1)):
            return False   # finest / res must be a power of two
    return (sorted(ints) == ints and spec.hidden_dim <= 8
            and spec.encoding_dim <= 64)


def grid_shape(spec: HashMLPSpec) -> tuple:
    """The scheduler's (nz, ny, nx) point grid: finest_res + 1 per axis."""
    rf = int(level_resolutions(spec)[-1])
    return (rf + 1,) * 3


def packed_cols(spec: HashMLPSpec) -> int:
    return spec.n_levels * 8 * spec.features_per_level


@functools.lru_cache(maxsize=16)
def _vertex_maps(spec: HashMLPSpec) -> tuple:
    """Per level the int32 (V, V, V) hash of every vertex of the level's
    grid (V = res_l + 1, index [z, y, x]): the reference's 3-prime XOR
    hash on uint32, mod table_size."""
    t_size = spec.table_size
    maps = []
    for rl in (int(r) for r in level_resolutions(spec)):
        v = np.arange(rl + 1, dtype=np.uint32)
        x = v[None, None, :]
        y = (v * np.uint32(_PRIME_Y))[None, :, None]
        z = (v * np.uint32(_PRIME_Z))[:, None, None]
        maps.append(((x ^ y ^ z) % np.uint32(t_size)).astype(np.int32))
    return tuple(maps)


def _level_ratios(spec: HashMLPSpec) -> tuple:
    res = [int(r) for r in level_resolutions(spec)]
    return tuple(float(r) / float(res[-1]) for r in res)


@functools.lru_cache(maxsize=16)
def _packed_index(spec: HashMLPSpec) -> np.ndarray:
    """(R, C) int32: the flat (L*T*F) table entry each packed value
    copies, or L*T*F (a zero) for the pad rows and the far faces. Row v =
    finest cell (iz, iy, ix) at full pitch; level l's corner (dz, dy, dx)
    reads the vertex c0 + (dx, dy, dz) with c0 = cell // (rf / res_l)."""
    res = [int(r) for r in level_resolutions(spec)]
    rf, n_f, t_size = res[-1], spec.features_per_level, spec.table_size
    npts = rf + 1
    zero = spec.n_levels * t_size * n_f
    cols = []
    for level, (rl, vmap) in enumerate(zip(res, _vertex_maps(spec))):
        c0 = np.arange(rf) // (rf // rl)
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    h = vmap[np.ix_(c0 + dz, c0 + dy, c0 + dx)]
                    for f in range(n_f):
                        cols.append((level * t_size + h) * n_f + f)
    full = np.full((npts, npts, npts, len(cols)), zero, np.int32)
    full[:rf, :rf, :rf] = np.stack(cols, axis=-1)
    out = np.full((fullpitch_rows((npts,) * 3), len(cols)), zero, np.int32)
    out[:npts ** 3] = full.reshape(npts ** 3, -1)
    return out


@functools.lru_cache(maxsize=16)
def _vertex_plan(spec: HashMLPSpec):
    """The adjoint's plan from level vertices to table entries: every
    level's vertices in (level, z, y, x) order name table row l*T + hash;
    a GatherPlan over those rows (exact-count classes, gathers and sums)."""
    t_size = spec.table_size
    rows = np.concatenate([level * t_size + vmap.reshape(-1)
                           for level, vmap in enumerate(_vertex_maps(spec))])
    return build_gather_plan(rows.astype(np.int32), spec.n_levels * t_size)


@functools.lru_cache(maxsize=16)
def _packed_index_on(spec: HashMLPSpec, device: torch.device):
    return torch.from_numpy(_packed_index(spec)).to(device)


@functools.lru_cache(maxsize=16)
def _vertex_plan_on(spec: HashMLPSpec, device: torch.device):
    return _vertex_plan(spec).to(device)


def build_hash_grid_table(params: dict, spec: HashMLPSpec) -> torch.Tensor:
    """(R, C) f32 packed multi-level corner table, one row per finest cell
    at the dense scheduler's full-pitch row id; column (l*8 + corner)*F +
    f with corner = dz*4 + dy*2 + dx. One gather of the hash table (with
    a zero appended for the pad rows and far faces); equal to
    ``dvren_tpu``'s bit for bit."""
    table = params["hash_table"]
    idx = _packed_index_on(spec, table.device)
    flat = torch.cat([table.reshape(-1).to(torch.float32),
                      table.new_zeros(1, dtype=torch.float32)])
    return torch.index_select(flat, 0, idx.reshape(-1)).reshape(idx.shape)


def hash_grid_table_grad(d_packed: torch.Tensor,
                         spec: HashMLPSpec) -> torch.Tensor:
    """Adjoint of :func:`build_hash_grid_table`: the (R, C) packed-table
    cotangent -> d(hash_table) (L, T, F), with gathers and sums only.

    Per level, the finest cells sharing a level cell sum by a reshape
    (blocks of k = rf / res_l per axis), and each corner (dz, dy, dx)
    adds its block sums into the level's vertex grid shifted by one step
    along the axes where d = 1, in corner order. The vertices then sum
    into their hash entries through :func:`_vertex_plan` (many vertices
    share an entry at the fine levels). No ``index_add_`` or scatter:
    their float atomics on CUDA add in a run-dependent order."""
    res = [int(r) for r in level_resolutions(spec)]
    rf, n_f, n_l = res[-1], spec.features_per_level, spec.n_levels
    npts = rf + 1
    d = d_packed[:npts ** 3].reshape(npts, npts, npts, n_l, 8, n_f)
    d = d[:rf, :rf, :rf]
    verts = []
    for level, rl in enumerate(res):
        k = rf // rl
        blk = d[:, :, :, level].reshape(rl, k, rl, k, rl, k, 8, n_f).sum(
            dim=(1, 3, 5))                                  # (rl^3, 8, F)
        v = None
        for corner in range(8):
            dz, dy, dx = corner >> 2, (corner >> 1) & 1, corner & 1
            part = torch.nn.functional.pad(
                blk[..., corner, :], (0, 0, dx, 1 - dx, dy, 1 - dy, dz, 1 - dz))
            v = part if v is None else v + part
        verts.append(v.reshape(-1, n_f))
    out = slot_rows_to_table(torch.cat(verts),
                             _vertex_plan_on(spec, d_packed.device),
                             n_l * spec.table_size)
    return out.reshape(n_l, spec.table_size, n_f)


# ------------------------------------------------------------- the kernels


@dataclass(frozen=True)
class GridParams:
    """Static constants of one hash-grid tile group: the fields of
    ``fused_tiles.TileParams`` (the lattice and the fraction constants of
    the finest level's point grid over the unit cube) plus the spec and
    its level ratios res_l / res_finest."""

    n_chunks: int
    banks: int
    dt: float
    t_near: float
    t_far: float
    k_max: int
    stop: float
    lo: tuple
    inv: tuple
    ns: tuple
    ratios: tuple
    spec: HashMLPSpec

    @property
    def t_stop(self) -> float:
        """End of the depth cursor: min(t_far, t_near + k_max * dt)."""
        return min(float(self.t_far),
                   float(self.t_near) + float(self.k_max) * float(self.dt))

    @property
    def cols(self) -> int:
        return packed_cols(self.spec)


def grid_op_params(plan: Plan, spec: HashMLPSpec, nb: int,
                   n_chunks: int) -> GridParams:
    nz, ny, nx = grid_shape(spec)
    return GridParams(
        n_chunks=int(n_chunks), banks=int(nb), dt=float(plan.sampling.dt),
        t_near=float(plan.t_near), t_far=float(plan.t_far),
        k_max=int(plan.sampling.max_steps), stop=float(STOP_THRESHOLD),
        lo=(0.0, 0.0, 0.0), inv=(1.0, 1.0, 1.0),
        ns=(float(nx - 1), float(ny - 1), float(nz - 1)),
        ratios=_level_ratios(spec), spec=spec)


def _check_inputs(tabs, samp, base, rayt, ke, bank0, sc, prm: GridParams,
                  gs=None):
    t_cnt = tabs.shape[0]
    nc, nb = prm.n_chunks, prm.banks
    want = {
        "tabs": (tabs, (t_cnt, nb, prm.cols, LANES), torch.float32),
        "samp": (samp, (t_cnt, nc, 3, ROWS, LANES), torch.uint16),
        "base": (base, (t_cnt, nb, 3, LANES), torch.float32),
        "rayt": (rayt, (t_cnt, RAYT_ROWS, LANES), torch.float32),
        "ke": (ke, (t_cnt,), torch.int32),
        "bank0": (bank0, (t_cnt * nc,), torch.int32),
        "sc": (sc, (_mlp_layout(prm.spec)["total"],), torch.float32),
    }
    if gs is not None:
        want["gs"] = (gs, (t_cnt, 5, ROWS, RAYS_COLS), torch.float32)
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: want {dtype}, got {x.dtype}")
        if x.device != tabs.device:
            raise ValueError(f"{name} on {x.device}, tabs on {tabs.device}")
    if tabs.device.type == "cuda":
        for name, (x, _, _) in want.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif tabs.device.type != "cpu":
        raise ValueError(f"unsupported device {tabs.device}")


def _kernel_args(prm: GridParams):
    spec = prm.spec
    ratios = (ctypes.c_float * len(prm.ratios))(*prm.ratios)
    return ratios, (prm.n_chunks, prm.banks, prm.k_max, spec.n_levels,
                    spec.features_per_level, spec.hidden_dim,
                    prm.dt, prm.t_near, prm.t_far, prm.t_stop, prm.stop,
                    *prm.lo, *prm.inv, *prm.ns)


def hash_grid_forward(tabs, samp, base, rayt, ke, bank0, sc,
                      prm: GridParams) -> torch.Tensor:
    """K8f: one tile group's raw heads, (T, 5, 16, 16) float32 (r, g, b,
    weighted mid-depth, processed optical depth).

    tabs (T, NB, C, 128) f32 bank tables of :func:`build_hash_grid_table`,
    samp (T, nc, 3, 16, 128) u16, base (T, NB, 3, 128) f32, rayt
    (T, 12, 128) f32, ke (T,) i32, bank0 (T * nc,) i32 (the dense
    schedule's), sc (P,) f32 packed MLP scalars."""
    _check_inputs(tabs, samp, base, rayt, ke, bank0, sc, prm)
    if tabs.device.type == "cpu":
        return hash_grid_forward_plain(tabs, samp, base, rayt, ke, bank0,
                                       sc, prm)
    t_cnt = int(tabs.shape[0])
    out = torch.empty((t_cnt, 5, ROWS, RAYS_COLS), dtype=torch.float32,
                      device=tabs.device)
    ratios, consts = _kernel_args(prm)
    lib = _build.library()
    with torch.cuda.device(tabs.device):
        code = lib.dvt_hash_grid_forward(
            tabs.data_ptr(), samp.data_ptr(), base.data_ptr(),
            rayt.data_ptr(), ke.data_ptr(), bank0.data_ptr(), sc.data_ptr(),
            out.data_ptr(), t_cnt, *consts,
            ctypes.cast(ratios, ctypes.c_void_p),
            _build.stream_ptr(tabs.device))
    _build.check(code, "dvt_hash_grid_forward")
    hash_grid_forward.launches += 1
    return out


hash_grid_forward.launches = 0


class _GridLattice(_Lattice):
    """A hash-grid tile group's decoded schedule (``fused_tiles._Lattice``)
    and the per-chunk encoding, in the kernels' order of arithmetic."""

    def __init__(self, tabs, samp, base, rayt, ke, bank0, prm: GridParams):
        super().__init__(tabs, samp, base, rayt, ke, bank0, prm)
        self.ratios = [(r, torch.tensor(r, dtype=torch.float32,
                                        device=self.dev))
                       for r in prm.ratios]
        self.spec = prm.spec

    def planes(self, c, mlp):
        """Chunk c: ((sigma, r, g, b) as (T, 256, 8), masked; the encoding
        planes (T, 2048) each; the heads' pre-activations; the per-level
        axis weights; idx2; the mask (T, 2048))."""
        vals, cbase, idx2 = self.expand(c)
        fs = self.coords(c)
        n_f = self.spec.features_per_level
        enc, wl = [], []
        for level, (ratio, r) in enumerate(self.ratios):
            if ratio == 1.0:
                ts = [fs[ax] - cbase[:, ax] for ax in range(3)]
            else:
                ts = [fs[ax] * r - torch.floor(cbase[:, ax] * r)
                      for ax in range(3)]
            weights = tuple((1.0 - t, t) for t in ts)
            wl.append(weights)
            w8 = corner_weights(weights)
            for f in range(n_f):
                acc = w8[0] * vals[:, level * 8 * n_f + f]
                for corner in range(1, 8):
                    acc = acc + w8[corner] * vals[:, (level * 8 + corner)
                                                  * n_f + f]
                enc.append(acc)
        out, pre = heads_from_planes(enc, mlp)
        m = self.m_all[:, c]
        shape = (self.t_cnt, RAYS_PER_TILE, GROUP)
        return ([(o * m).reshape(shape) for o in out], enc, pre, wl, idx2,
                m)


def hash_grid_forward_plain(tabs, samp, base, rayt, ke, bank0, sc,
                            prm: GridParams) -> torch.Tensor:
    """Plain twin of K8f, vectorised over tiles and rays; loops over
    chunks and the 8 steps of the recurrence, in the kernel's order of
    arithmetic."""
    lat = _GridLattice(tabs, samp, base, rayt, ke, bank0, prm)
    mlp = _mlp_from_scalars(sc, prm.spec)
    return march_plain(lat, lambda c: lat.planes(c, mlp)[0])


def hash_grid_backward_plain(tabs, samp, base, rayt, ke, bank0, sc, gs,
                             prm: GridParams):
    """Plain twin of K8b: (d_rows (T, NB, 128, C), d_mlp (P,)) for the
    per-ray cotangents ``gs`` (T, 5, 16, 16) of K8f's heads.

    Pass 1 recomputes every sample's optical-depth prefix in K8f's order.
    Pass 2 walks the chunks and their steps in reverse with the adjoint of
    the telescoped weights (suffix sums of gw * w), then through the mask
    and both heads with JAX's tie values written out (0.5 at max(x, 0) ==
    0 and at each end of the colour clamp), to d(encoding) and the C
    products w8_l[corner] * d(enc)[l*F + f] per sample. Per-sample values
    follow the kernel's order of arithmetic. The sums over samples run in
    float64 and round once: the slot rows by ``index_add_`` into each
    sample's window slot (in float32 the card's ``index_add_``, atomics in
    no fixed order, rounds more than K8b's ordered sums), the MLP
    gradients as matrix products."""
    spec = prm.spec
    lat = _GridLattice(tabs, samp, base, rayt, ke, bank0, prm)
    mlp = _mlp_from_scalars(sc, spec)
    t_cnt, nb, nc, dev = lat.t_cnt, lat.nb, lat.nc, lat.dev
    hid, n_f, n_cols = spec.hidden_dim, spec.features_per_level, prm.cols
    g = gs.reshape(t_cnt, 5, RAYS_PER_TILE, 1)
    g_r, g_g, g_b, g_wd, g_odp = (g[:, i] for i in range(5))
    zeros = torch.zeros((t_cnt, RAYS_PER_TILE), dtype=torch.float32,
                        device=dev)

    # pass 1: the exclusive optical-depth prefix of every sample
    s, s_pre = zeros, []
    for c in range(nc):
        sig = lat.planes(c, mlp)[0][0]
        livef, dta, _ = lat.chunk_time(c)
        od = torch.clamp_min(sig * dta, 0.0) * livef
        pre = []
        for j in range(GROUP):
            pre.append(s)
            s = s + od[..., j]
        s_pre.append(torch.stack(pre, dim=-1))                # (T, 256, 8)

    # pass 2: the reverse adjoint
    acc = torch.zeros((t_cnt * nb * LANES, n_cols), dtype=torch.float64,
                      device=dev)
    d_mlp = {k: torch.zeros(v.shape, dtype=torch.float64, device=dev)
             for k, v in mlp.items()}
    carry = zeros
    for c in reversed(range(nc)):
        (sig, cr, cg, cb), enc, pre, wl, idx2, m = lat.planes(c, mlp)
        s_pre1, s_pre2, c_pre1, c_pre2, s_h, c_h = pre
        livef, dta, mid = lat.chunk_time(c)
        x = sig * dta
        od = torch.clamp_min(x, 0.0) * livef
        tb = torch.exp(-s_pre[c])
        p = torch.exp(-(s_pre[c] + od))
        procf = livef * (tb > lat.stop).to(torch.float32)
        w = (tb - p) * procf
        gw = g_r * cr + g_g * cg + g_b * cb + g_wd * mid
        gww = gw * w
        dod = [None] * GROUP
        for j in reversed(range(GROUP)):
            dod[j] = ((gw[..., j] * procf[..., j]) * p[..., j] - carry
                      + g_odp[..., 0] * procf[..., j])
            carry = carry + gww[..., j]
        dod = torch.stack(dod, dim=-1)

        def flat(v):
            return v.reshape(t_cnt, CHUNK_SAMPLES)

        dsig = flat(((dod * livef) * _tie(x)) * dta) * m
        dsig2 = dsig * _tie(s_pre2)
        dc2 = []
        for ch, gc in enumerate((g_r, g_g, g_b)):
            y2 = torch.clamp_min(c_pre2[ch], 0.0)
            t_hi = torch.where(y2 < 1.0, 1.0, torch.where(y2 > 1.0, 0.0, 0.5))
            dc2.append(((flat(gc * w) * m) * t_hi) * _tie(c_pre2[ch]))
        ds1 = [(dsig2 * mlp["sigma_w2"][j]) * _tie(s_pre1[j])
               for j in range(hid)]
        dc1 = []
        for j in range(hid):
            dh = dc2[0] * mlp["color_w2"][0, j]
            for ch in (1, 2):
                dh = dh + dc2[ch] * mlp["color_w2"][ch, j]
            dc1.append(dh * _tie(c_pre1[j]))
        denc = []
        for i in range(spec.encoding_dim):
            a = ds1[0] * mlp["sigma_w1"][0, i] + dc1[0] * mlp["color_w1"][0, i]
            for j in range(1, hid):
                a = a + (ds1[j] * mlp["sigma_w1"][j, i]
                         + dc1[j] * mlp["color_w1"][j, i])
            denc.append(a)

        def outer(a, b):
            return torch.stack([v.reshape(-1) for v in a]).double() @ \
                torch.stack([v.reshape(-1) for v in b]).double().T

        def total(vs):
            return torch.stack([v.reshape(-1) for v in vs]).double().sum(1)

        d_mlp["sigma_w1"] += outer(ds1, enc)
        d_mlp["sigma_b1"] += total(ds1)
        d_mlp["sigma_w2"] += outer([dsig2], s_h)[0]
        d_mlp["sigma_b2"] += dsig2.double().sum()
        d_mlp["color_w1"] += outer(dc1, enc)
        d_mlp["color_b1"] += total(dc1)
        d_mlp["color_w2"] += outer(dc2, c_h)
        d_mlp["color_b2"] += total(dc2)

        wp = []
        for level, weights in enumerate(wl):
            w8 = corner_weights(weights)
            for corner in range(8):
                for f in range(n_f):
                    wp.append(w8[corner] * denc[level * n_f + f])
        wp = torch.stack(wp, dim=-1)                        # (T, 2048, C)
        b0, b1, _ = lat.window(c)
        second = idx2 >= LANES
        bank = torch.where(second, b1, b0)
        lane = torch.where(second, idx2 - LANES, idx2).clamp(0, LANES - 1)
        row = (lat.tiles[:, None] * nb + bank) * LANES + lane
        ok = (idx2 >= 0) & (idx2 < 2 * LANES)
        acc.index_add_(0, row[ok], wp[ok].double())
    d_rows = acc.to(torch.float32).reshape(t_cnt, nb, LANES, n_cols)
    d_sc = torch.cat([d_mlp[k].reshape(-1) for k in MLP_KEYS]).to(
        torch.float32)
    return d_rows, d_sc


def hash_grid_backward(tabs, samp, base, rayt, ke, bank0, sc, gs,
                       prm: GridParams):
    """K8b: (d_rows (T, NB, 128, C) f32 slot rows, row (t * NB + b) * 128
    + lane; d_mlp (P,) in :func:`hash_tiles._mlp_layout` order) for the
    cotangent ``gs`` (T, 5, 16, 16) f32 of :func:`hash_grid_forward`.

    Launches ``csrc/hash_grid_bwd.cu``, which writes per-tile MLP
    partials, and sums them over the tiles (``torch.sum``: a fixed order,
    so repeat runs are bit-identical) for CUDA tensors; runs
    :func:`hash_grid_backward_plain` for CPU tensors."""
    _check_inputs(tabs, samp, base, rayt, ke, bank0, sc, prm, gs=gs)
    if tabs.device.type == "cpu":
        return hash_grid_backward_plain(tabs, samp, base, rayt, ke, bank0,
                                        sc, gs, prm)
    t_cnt, dev = int(tabs.shape[0]), tabs.device
    d_rows = torch.empty((t_cnt, prm.banks, LANES, prm.cols),
                         dtype=torch.float32, device=dev)
    part_mlp = torch.empty((t_cnt, int(sc.shape[0])), dtype=torch.float32,
                           device=dev)
    # each sample's optical-depth prefix, written by pass 1, read by pass 2
    s_pre = torch.empty((t_cnt, prm.n_chunks * GROUP, RAYS_PER_TILE),
                        dtype=torch.float32, device=dev)
    ratios, consts = _kernel_args(prm)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_hash_grid_backward(
            tabs.data_ptr(), samp.data_ptr(), base.data_ptr(),
            rayt.data_ptr(), ke.data_ptr(), bank0.data_ptr(), sc.data_ptr(),
            gs.data_ptr(), d_rows.data_ptr(), part_mlp.data_ptr(),
            s_pre.data_ptr(), t_cnt, *consts,
            ctypes.cast(ratios, ctypes.c_void_p), _build.stream_ptr(dev))
    _build.check(code, "dvt_hash_grid_backward")
    hash_grid_backward.launches += 1
    return d_rows, part_mlp.sum(dim=0)


hash_grid_backward.launches = 0
