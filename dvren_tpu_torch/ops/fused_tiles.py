"""Fused tile-group forward (K1) and backward (K2), and the helpers around
them.

Counterpart of ``dvren_tpu/ops/fused_tiles.py``: the Pallas
``_fwd_kernel`` becomes the CUDA kernel ``csrc/fused_tiles.cu`` and
``_bwd_kernel`` becomes ``csrc/fused_tiles_bwd.cu`` (both one thread per
ray, one block per 16x16 tile), with the plain PyTorch twins
:func:`tile_forward_plain` and :func:`tile_backward_plain` (one tile group
each) beside them.
The TPU kernels' layout machinery (mask-matmul prefix sums, lane-shuffle
slot expansion, the ``mxu``/``roll`` ablations, the u16 hi/lo split of the
backward's rows) has no counterpart: on the card a ray's prefix sum is a
running sum, and the rows stay f32.

Per sample K1 recomputes the trilinear fractions from the slim schedule
(sample_t bits, slot | mask bits, the tile's ray planes and the slot's
cell base), interpolates the stencil row of its slot from its sub-tile's
two-bank window, and runs the optical-depth recurrence with exact early
stop. Output per ray: r, g, b, sum of w * mid-segment depth, and
processed optical depth, as (T, 5, 16, 16) image tiles. K2 is its
recompute adjoint: d(bank table) as f32 slot rows (one (NB, 128, cols)
block per tile) and, on request, d(rayt) for camera gradients. For the
split backward (``render/tiled.py``'s ``BWD_SPLIT = "pallas"``) K2 also
emits the table gradient in JAX's ``emit="banks"`` layout, bank blocks
(NB, 32, 128) per tile,
the rows form transposed bit for bit (cell stencil only, as in JAX);
K6 (``packed_transpose.banks_to_rows``) then relays them to slot rows.

Two forms, as in the JAX kernels (``subs`` and ``stencil`` of
``tile_op_params``):

- ``subs`` 1, 4 or 16 sub-tiles per 16x16 block (16, 8 or 4 px tiles):
  block row r belongs to sub-tile r // (16 // subs), whose window starts
  at ``bank0[(t * nc + c) * subs + s]``;
- ``stencil`` "cell" (32 columns ch * 8 + corner, one slot per grid cell)
  or "super" (108 columns ch * 27 + vertex, one slot per 2x2x2 supercell;
  the packed word is lane (12 bits) | lb << 12 | m << 15, lb the sample's
  cell in its supercell). The supercell sample interpolates with 27 hat
  weights (hz * hy) * hx in vertex order vz * 9 + vy * 3 + vx, of which
  19 are exact zeros; the kernels read only the 8 vertices of the
  sample's cell, which gives the same sums to the last bit.

Each kernel launches once per schedule over every tile group: a
:class:`TileSet` holds the groups' arrays flat with a per-tile descriptor
(chunk and bank counts, first chunk, first bank), which the schedule
carries (``tiled.TiledSchedule.tiles``) and the hash-grid kernels K8f /
K8b read too; one group alone is a set of one shape (:func:`tile_set`).
:func:`tile_forward` and :func:`tile_backward` launch their kernels for
CUDA tensors and, for CPU tensors, run the twins group by group
(:func:`tile_forward_set_plain`, :func:`tile_backward_set_plain`); their
``.launches`` attributes count launches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.ops.integrate import OPACITY_EPS, STOP_THRESHOLD

ROWS = 16          # block rows per chunk
LANES = 128        # lanes per row (slots per bank)
GROUP = 8          # steps per chunk (lanes per ray)
RAYS_PER_TILE = 256
RAYS_COLS = 16     # output lanes per block row
NCH = 32           # cell columns: 4 (sigma, r, g, b) x 8 corners
SUPER_NCH = 108    # supercell columns: 4 x 27 vertices
RAYT_ROWS = 12     # compact ray planes: 6 axes x 2 halves of 128 rays
CHUNK_SAMPLES = ROWS * LANES
STENCILS = ("cell", "super")


@dataclass(frozen=True)
class TileParams:
    """Static constants of one tile group's forward (the port's
    ``tile_op_params``): chunk and bank counts, the lattice, the fraction
    constants lo / inv / ns per axis (x, y, z), the sub-tiles per block
    and the stencil."""

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
    subs: int = 1
    stencil: str = "cell"

    @property
    def t_stop(self) -> float:
        """End of the depth cursor: min(t_far, t_near + k_max * dt)."""
        return min(float(self.t_far),
                   float(self.t_near) + float(self.k_max) * float(self.dt))

    @property
    def cols(self) -> int:
        """Bank-table columns: 32 for the cell stencil, 108 for the
        supercell one."""
        return SUPER_NCH if self.stencil == "super" else NCH


def tile_op_params(plan: Plan, geom, nb: int, n_chunks: int, subs: int = 1,
                   stencil: str = "cell") -> TileParams:
    """Group constants from the plan and the schedule's field geometry
    ``geom = (bbox_min, bbox_max, grid_shape_zyx)``; computed in float64
    and rounded to float32 where they are used, as in the JAX package.
    ``subs``: sub-tiles per block, (16 // tile_px) ** 2; ``stencil``:
    "super" for a supercell schedule (cell_scale 2)."""
    if subs not in (1, 4, 16):
        raise ValueError(f"subs must be 1, 4 or 16, got {subs}")
    if stencil not in STENCILS:
        raise ValueError(f"stencil must be one of {STENCILS}, got {stencil!r}")
    bbox_min, bbox_max, grid_shape = geom
    nz, ny, nx = (int(v) for v in grid_shape)
    lo = tuple(float(v) for v in bbox_min)
    inv = tuple(
        float(1.0 / (float(hi) - float(l))) if float(hi) != float(l) else 0.0
        for l, hi in zip(bbox_min, bbox_max))
    ns = (float(nx - 1), float(ny - 1), float(nz - 1))
    return TileParams(
        n_chunks=int(n_chunks), banks=int(nb),
        dt=float(plan.sampling.dt), t_near=float(plan.t_near),
        t_far=float(plan.t_far), k_max=int(plan.sampling.max_steps),
        stop=float(STOP_THRESHOLD), lo=lo, inv=inv, ns=ns, subs=int(subs),
        stencil=stencil)


def finalize_heads(plan: Plan, raw: torch.Tensor, axis: int = 1):
    """Raw heads -> ((r, g, b), transmittance, opacity, depth)."""
    r, g, b, wd, odp = (raw.select(axis, i) for i in range(5))
    t_final = torch.exp(-odp)
    opacity = 1.0 - t_final
    depth = torch.where(
        opacity > OPACITY_EPS,
        wd / torch.clamp_min(opacity, OPACITY_EPS),
        torch.full_like(wd, float(plan.t_far)))
    return (r, g, b), t_final, opacity, depth


# ------------------------------------------------ every group in one launch

DESC_WORDS = 4   # per tile: n_chunks, banks, first chunk, first bank


def _concat(arrays, empty):
    """Concatenate numpy arrays, or tensors (u16 through an int16 view);
    ``empty`` when there are none."""
    if not arrays:
        return empty
    if isinstance(arrays[0], np.ndarray):
        return np.concatenate(arrays)
    if arrays[0].dtype == torch.uint16:
        return torch.cat([a.view(torch.int16) for a in arrays]).view(
            torch.uint16)
    return torch.cat(arrays)


@dataclass(frozen=True)
class TileSet:
    """Every tile group of a schedule as flat arrays, for one launch of a
    tile kernel (K1, K2, K8f, K8b) over all of them. The groups' arrays
    concatenated in group order, with S_c = sum of n_tiles * n_chunks and
    S_b = sum of n_tiles * banks over the groups:

    samp (S_c, 3, 16, 128) u16, base (S_b, 3, 128) f32, rayt (T, 12, 128)
    f32, ke (T,) i32, bank0 (S_c * subs,) i32; desc (T, 4) i32, per tile
    its n_chunks, banks, first chunk (into samp, bank0 / subs) and first
    bank (into base, the bank tables and the backward's slot rows); and
    order (T,) i32, the tiles by falling chunk count (stable), the order
    in which K1 and K2 hand tiles to blocks so that the longest start
    first (no output moves). ``shapes`` holds each group's (n_tiles,
    n_chunks, banks). Numpy arrays as built, or tensors after :meth:`to`;
    a lone group is a set of one shape (:func:`tile_set`)."""

    shapes: tuple
    subs: int
    samp: np.ndarray
    base: np.ndarray
    rayt: np.ndarray
    ke: np.ndarray
    bank0: np.ndarray
    desc: np.ndarray
    order: np.ndarray

    def to(self, device) -> "TileSet":
        def move(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(device)

        return TileSet(
            shapes=self.shapes, subs=self.subs, samp=move(self.samp),
            base=move(self.base), rayt=move(self.rayt), ke=move(self.ke),
            bank0=move(self.bank0), desc=move(self.desc),
            order=move(self.order))

    @property
    def device(self):
        return (self.samp.device if isinstance(self.samp, torch.Tensor)
                else None)

    @property
    def n_tiles(self) -> int:
        return sum(n for n, _, _ in self.shapes)

    @property
    def n_chunk_rows(self) -> int:
        """S_c: the chunks of every tile."""
        return sum(n * nc for n, nc, _ in self.shapes)

    @property
    def n_bank_rows(self) -> int:
        """S_b: the banks of every tile."""
        return sum(n * nb for n, _, nb in self.shapes)

    @property
    def max_chunks(self) -> int:
        return max((nc for _, nc, _ in self.shapes), default=0)

    @property
    def max_banks(self) -> int:
        return max((nb for _, _, nb in self.shapes), default=0)

    def offsets(self) -> list:
        """Per group (first tile, first chunk, first bank)."""
        out, t0, c0, b0 = [], 0, 0, 0
        for n, nc, nb in self.shapes:
            out.append((t0, c0, b0))
            t0, c0, b0 = t0 + n, c0 + n * nc, b0 + n * nb
        return out

    def group_arrays(self) -> list:
        """Per group its (T, ...) arrays as views of the flat ones: samp,
        base, rayt, k_enter and bank0 (T, nc, subs), named as
        ``tiled.TileGroup``'s fields."""
        out = []
        for (n, nc, nb), (t0, c0, b0) in zip(self.shapes, self.offsets()):
            out.append({
                "samp": self.samp[c0:c0 + n * nc].reshape(
                    (n, nc) + tuple(self.samp.shape[1:])),
                "base": self.base[b0:b0 + n * nb].reshape(
                    (n, nb) + tuple(self.base.shape[1:])),
                "rayt": self.rayt[t0:t0 + n],
                "k_enter": self.ke[t0:t0 + n],
                "bank0": self.bank0[c0 * self.subs:(c0 + n * nc)
                                    * self.subs].reshape(n, nc, self.subs)})
        return out

    def group_views(self, tabs, rayt=None) -> list:
        """Per group the one-group twins' arguments, as views: (tabs
        (T, NB, C, 128) from the flat bank tables ``tabs`` (S_b, C, 128),
        samp, base, rayt (``rayt`` (T_all, 12, 128) in place of the set's
        when given), ke, bank0 (T * nc * subs,))."""
        rayt = self.rayt if rayt is None else rayt
        out = []
        for (n, nc, nb), (t0, _, b0), arrays in zip(
                self.shapes, self.offsets(), self.group_arrays()):
            out.append((tabs[b0:b0 + n * nb].reshape(
                (n, nb) + tuple(tabs.shape[1:])),
                arrays["samp"], arrays["base"], rayt[t0:t0 + n],
                arrays["k_enter"], arrays["bank0"].reshape(-1)))
        return out


def tile_set(groups, subs: int) -> TileSet:
    """The flat arrays and descriptor of ``groups`` (``tiled.TileGroup``s,
    numpy or tensors on one device): copies, in group order."""
    shapes = tuple((int(g.n_tiles), int(g.n_chunks), int(g.banks))
                   for g in groups)
    desc = []
    c0 = b0 = 0
    for n, nc, nb in shapes:
        d = np.empty((n, DESC_WORDS), np.int32)
        d[:, 0], d[:, 1] = nc, nb
        d[:, 2] = c0 + nc * np.arange(n)
        d[:, 3] = b0 + nb * np.arange(n)
        desc.append(d)
        c0, b0 = c0 + n * nc, b0 + n * nb
    desc = (np.concatenate(desc) if desc
            else np.zeros((0, DESC_WORDS), np.int32))
    order = np.argsort(-desc[:, 0], kind="stable").astype(np.int32)

    def flat(name, tail, dtype):
        return _concat([getattr(g, name).reshape((-1,) + tail)
                        for g in groups], np.zeros((0,) + tail, dtype))

    tiles = TileSet(
        shapes=shapes, subs=int(subs),
        samp=flat("samp", (3, ROWS, LANES), np.uint16),
        base=flat("base", (3, LANES), np.float32),
        rayt=flat("rayt", (RAYT_ROWS, LANES), np.float32),
        ke=flat("k_enter", (), np.int32), bank0=flat("bank0", (), np.int32),
        desc=desc, order=order)
    dev = tiles.device
    return tiles if dev is None else dataclasses.replace(
        tiles, desc=torch.from_numpy(desc).to(dev),
        order=torch.from_numpy(order).to(dev))


def tiles_op_params(plan: Plan, geom, tiles: TileSet,
                    stencil: str = "cell") -> TileParams:
    """The constants of a one-launch call over ``tiles``: the groups'
    largest chunk and bank counts (each tile's own come from the
    descriptor) and the set's sub-tiles per block."""
    return tile_op_params(plan, geom, tiles.max_banks, tiles.max_chunks,
                          tiles.subs, stencil)


def check_tiles(tabs, tiles: TileSet, cols: int, subs: int,
                rayt=None, extra=None) -> None:
    """Shapes, dtypes and devices of a one-launch call over ``tiles``:
    the flat bank tables ``tabs`` (S_b, cols, 128), the set's arrays (its
    ray planes or ``rayt``) and ``extra`` {name: (tensor, shape,
    dtype)}; CUDA tensors must be contiguous."""
    s_c, s_b, t_cnt = tiles.n_chunk_rows, tiles.n_bank_rows, tiles.n_tiles
    if subs != tiles.subs:
        raise ValueError(f"params for subs {subs}, tiles of subs "
                         f"{tiles.subs}")
    want = {
        "tabs": (tabs, (s_b, cols, LANES), torch.float32),
        "samp": (tiles.samp, (s_c, 3, ROWS, LANES), torch.uint16),
        "base": (tiles.base, (s_b, 3, LANES), torch.float32),
        "rayt": (tiles.rayt if rayt is None else rayt,
                 (t_cnt, RAYT_ROWS, LANES), torch.float32),
        "ke": (tiles.ke, (t_cnt,), torch.int32),
        "bank0": (tiles.bank0, (s_c * tiles.subs,), torch.int32),
        "desc": (tiles.desc, (t_cnt, DESC_WORDS), torch.int32),
        "order": (tiles.order, (t_cnt,), torch.int32),
        **(extra or {}),
    }
    for name, (x, shape, dtype) in want.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: want a tensor (move the tiles with "
                            f".to(device))")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: want {dtype}, got {x.dtype}")
        if x.device != tabs.device:
            raise ValueError(f"{name} on {x.device}, tabs on {tabs.device}")
        if tabs.device.type == "cuda" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tabs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tabs.device}")


def _group_params(tiles: TileSet, prm: TileParams) -> list:
    return [dataclasses.replace(prm, n_chunks=nc, banks=nb)
            for _, nc, nb in tiles.shapes]


def tile_forward_set_plain(tabs, tiles: TileSet, prm: TileParams,
                           rayt=None) -> torch.Tensor:
    """:func:`tile_forward_plain` group by group, concatenated."""
    outs = [tile_forward_plain(*a, p) for a, p in zip(
        tiles.group_views(tabs, rayt), _group_params(tiles, prm))]
    if not outs:
        return tabs.new_zeros((0, 5, ROWS, RAYS_COLS))
    return torch.cat(outs)


def tile_forward(tabs, tiles: TileSet, prm: TileParams,
                 rayt=None) -> torch.Tensor:
    """K1 over every tile group of a schedule in one launch: the raw heads
    (T, 5, 16, 16) float32 of the groups' tiles in group order.

    ``tabs`` (S_b, cols, 128) f32 are the flat bank tables
    (``tiled._gather_banks_flat``; cols = ``prm.cols``), ``prm`` comes
    from :func:`tiles_op_params`, ``rayt`` (T, 12, 128) replaces the
    set's ray planes when given (the camera route). CPU tensors run
    :func:`tile_forward_plain` group by group."""
    check_tiles(tabs, tiles, prm.cols, prm.subs, rayt)
    rayt = tiles.rayt if rayt is None else rayt
    if tabs.device.type == "cpu":
        return tile_forward_set_plain(tabs, tiles, prm, rayt)
    t_cnt = tiles.n_tiles
    out = torch.empty((t_cnt, 5, ROWS, RAYS_COLS), dtype=torch.float32,
                      device=tabs.device)
    lib = _build.library()
    with torch.cuda.device(tabs.device):
        code = lib.dvt_tile_forward(
            tabs.data_ptr(), tiles.samp.data_ptr(), tiles.base.data_ptr(),
            rayt.data_ptr(), tiles.ke.data_ptr(), tiles.bank0.data_ptr(),
            tiles.desc.data_ptr(), tiles.order.data_ptr(), out.data_ptr(),
            t_cnt, prm.k_max,
            prm.subs, int(prm.stencil == "super"),
            prm.dt, prm.t_near, prm.t_far, prm.t_stop, prm.stop,
            *prm.lo, *prm.inv, *prm.ns,
            _build.stream_ptr(tabs.device))
    _build.check(code, "dvt_tile_forward")
    tile_forward.launches += 1
    return out


tile_forward.launches = 0


def decode_samples(samp: torch.Tensor):
    """(T, nc, 3, 16, 128) u16 slim schedule -> per-chunk flat planes
    (T, nc, 2048): sample_t (f32, from its hi/lo bits), the mask (f32)
    and the 15 packed bits below it (int32: the tile-local lane, or for a
    supercell schedule lane | lb << 12). Sample q = ray * 8 + step of a
    chunk sits at block row q // 128, lane q % 128, so the flat view needs
    no shuffle. torch has no shifts or masks on uint16: widen first."""
    t_cnt, nc = samp.shape[:2]
    s32 = samp.to(torch.int32).reshape(t_cnt, nc, 3, CHUNK_SAMPLES)
    st = ((s32[:, :, 0] << 16) | s32[:, :, 1]).view(torch.float32)
    m = ((s32[:, :, 2] >> 15) & 1).to(torch.float32)
    return st, m, s32[:, :, 2] & 0x7FFF


class _Lattice:
    """One tile group's decoded schedule and float32 constants, shared by
    the plain twins of K1 and K2 (and K8's). Every per-chunk value is
    computed in the kernels' order of arithmetic."""

    def __init__(self, tabs, samp, base, rayt, ke, bank0, prm):
        self.t_cnt, self.nb, self.nc = int(tabs.shape[0]), prm.banks, \
            prm.n_chunks
        self.prm = prm
        self.subs = getattr(prm, "subs", 1)
        self.super = getattr(prm, "stencil", "cell") == "super"
        dev = self.dev = tabs.device

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        self.dt, self.t_near, self.t_far = (f32(prm.dt), f32(prm.t_near),
                                            f32(prm.t_far))
        self.t_stop, self.stop = f32(prm.t_stop), f32(prm.stop)
        self.lo = [f32(v) for v in prm.lo]
        self.inv = [f32(v) for v in prm.inv]
        self.ns = [f32(v) for v in prm.ns]
        self.st_all, self.m_all, bits = decode_samples(samp)
        if self.super:
            # lane (12 bits) | lx << 12 | ly << 13 | lz << 14
            self.lane_all = bits & 0xFFF
            self.lb_all = [(bits >> (12 + ax)) & 1 for ax in range(3)]
        else:
            self.lane_all, self.lb_all = bits, None
        self.rays = rayt.reshape(self.t_cnt, 6, RAYS_PER_TILE) \
            .repeat_interleave(GROUP, dim=2)                   # (T, 6, 2048)
        self.b0_all = (bank0.reshape(self.t_cnt, self.nc, self.subs)
                       & 0x3FFF).long()
        # each sample's sub-tile: block rows r // (16 // subs)
        self.sub_of = torch.arange(CHUNK_SAMPLES, device=dev) // (
            CHUNK_SAMPLES // self.subs)
        # the tile's bank lanes flat: (T, C, NB * 128)
        self.tabs_f = tabs.permute(0, 2, 1, 3).reshape(
            self.t_cnt, tabs.shape[2], self.nb * LANES)
        self.base_f = base.permute(0, 2, 1, 3).reshape(
            self.t_cnt, 3, self.nb * LANES)
        self.tiles = torch.arange(self.t_cnt, device=dev)
        self.step = (torch.arange(CHUNK_SAMPLES, device=dev) % GROUP)[None]
        self.ke32 = ke.to(torch.int32)
        self.t_origin = self.t_near + self.ke32.to(torch.float32) * self.dt
        self.t_origin_c = torch.minimum(self.t_origin, self.t_stop)

    def window(self, c):
        """Chunk c's window banks (b0, b1) and window-relative slots idx2
        of every sample, each (T, 2048): the window of the sample's
        sub-tile, b1 = min(b0 + 1, NB - 1)."""
        b0 = self.b0_all[:, c][:, self.sub_of]
        b1 = torch.clamp(b0 + 1, max=self.nb - 1)
        idx2 = self.lane_all[:, c] - (b0 * LANES).to(torch.int32)
        return b0, b1, idx2

    def expand(self, c):
        """Chunk c's window values per sample: (vals (T, C, 2048), the
        bank table's C columns at each sample's slot; cbase (T, 3, 2048),
        the slot's cell base; idx2). A slot past the window clamps into
        its bank, as the kernels read it."""
        b0, b1, idx2 = self.window(c)
        second = idx2 >= LANES
        slot = torch.where(second, idx2 - LANES, idx2).clamp(0, LANES - 1)
        flat = torch.where(second, b1, b0) * LANES + slot.long()

        def gather(table):
            n = table.shape[1]
            return torch.gather(table, 2,
                                flat[:, None].expand(self.t_cnt, n, -1))

        return gather(self.tabs_f), gather(self.base_f), idx2

    def coords(self, c):
        """Chunk c's sample coordinates on the grid's cell scale,
        ((p - lo) * inv) * ns per axis, each (T, 2048)."""
        st = self.st_all[:, c]
        return [((self.rays[:, ax] + self.rays[:, 3 + ax] * st)
                 - self.lo[ax]) * self.inv[ax] * self.ns[ax]
                for ax in range(3)]

    def chunk(self, c):
        """Chunk c: (vals (T, C, 2048) stencil values per sample, the
        axis weights ((1 - tx, tx), (1 - ty, ty), m-folded z), the
        planes sigma, r, g, b as (T, 256, 8), idx2). A supercell sample's
        cell base is its supercell's vertex origin plus lb, an exact
        float32 add."""
        t_cnt = self.t_cnt
        vals, cbase, idx2 = self.expand(c)
        m = self.m_all[:, c]
        w = []
        for ax, f in enumerate(self.coords(c)):
            cb = cbase[:, ax]
            if self.super:
                cb = cb + self.lb_all[ax][:, c].to(torch.float32)
            frac = f - cb
            w.append((1.0 - frac, frac))
        wx, wy, wz = w
        wz = (m * wz[0], m * wz[1])
        if self.super:
            wv, per = hat_weights((wx, wy, wz), self.lbits(c)), 27
        else:
            wv, per = corner_weights((wx, wy, wz)), 8
        planes = []
        for ch in range(4):
            a = wv[0] * vals[:, ch * per]
            for v in range(1, per):
                a = a + wv[v] * vals[:, ch * per + v]
            planes.append(a.reshape(t_cnt, RAYS_PER_TILE, GROUP))
        return vals, (wx, wy, wz), planes, idx2

    def lbits(self, c):
        """Chunk c's cell-in-supercell bits (lx, ly, lz), each (T, 2048)."""
        return [lb[:, c] for lb in self.lb_all]

    def slot_products(self, c, weights, dpl):
        """d(stencil row) per sample, (T, C, 2048): the stencil weight of
        each column times the d-plane of its channel (``dpl``: d sigma,
        d r, d g, d b, each (T, 2048))."""
        if self.super:
            wv, per = hat_weights(weights, self.lbits(c)), 27
        else:
            wv, per = corner_weights(weights), 8
        return torch.stack([wv[v] * dpl[ch] for ch in range(4)
                            for v in range(per)], dim=1)

    def corner_values(self, vals, c):
        """The 32 values ch * 8 + corner of each sample's cell, (T, 32,
        2048): ``vals`` itself for the cell stencil; for a supercell, its
        vertices (lz + dz, ly + dy, lx + dx)."""
        if not self.super:
            return vals
        lx, ly, lz = self.lbits(c)
        vert = torch.stack([(lz + dz) * 9 + (ly + dy) * 3 + (lx + dx)
                            for dz in (0, 1) for dy in (0, 1)
                            for dx in (0, 1)], dim=1)          # (T, 8, 2048)
        idx = torch.cat([vert + ch * 27 for ch in range(4)], dim=1)
        return torch.gather(vals, 1, idx.long())

    def chunk_time(self, c):
        """(livef, dt_actual, mid-segment depth) of chunk c's steps, each
        (T, 256, 8)."""
        k = self.ke32[:, None] + c * GROUP + self.step          # (T, 2048)
        base_t = self.t_near + k.to(torch.float32) * self.dt
        live = (base_t < self.t_far) & (k < self.prm.k_max)
        livef = live.to(torch.float32)
        dta = torch.where(live,
                          torch.minimum(base_t + self.dt, self.t_far) - base_t,
                          torch.zeros_like(base_t))
        tcur = self.t_origin[:, None] + torch.clamp_min(
            torch.minimum(base_t, self.t_stop) - self.t_origin_c[:, None], 0.0)
        mid = tcur + 0.5 * dta
        shape = (self.t_cnt, RAYS_PER_TILE, GROUP)
        return livef.reshape(shape), dta.reshape(shape), mid.reshape(shape)


def hat_weights(weights, lbits):
    """The 27 supercell vertex weights in vertex order vz*9 + vy*3 + vx,
    each (hz * hy) * hx with the hat h[a] = w0 where a == l, w1 where
    a == l + 1 and an exact 0.0 elsewhere (``dvren_tpu``'s
    ``_hat_weights``): the 8 nonzero ones equal the cell's corner weights
    bit for bit."""
    hats = []
    for (w0, w1), lb in zip(weights, lbits):
        zero = torch.zeros_like(w0)
        hats.append([torch.where(lb == a, w0,
                                 torch.where(lb == a - 1, w1, zero))
                     for a in range(3)])
    hx, hy, hz = hats
    hzy = [[hz[vz] * hy[vy] for vy in range(3)] for vz in range(3)]
    return [hzy[vz][vy] * hx[vx]
            for vz in range(3) for vy in range(3) for vx in range(3)]


def corner_weights(weights):
    """The eight trilinear corner weights in packed-corner order
    (dz*4 + dy*2 + dx), each (wz * wy) * wx."""
    wx, wy, wz = weights
    return [wz[dz] * wy[dy] * wx[dx]
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def tile_forward_plain(tabs, samp, base, rayt, ke, bank0,
                       prm: TileParams) -> torch.Tensor:
    """Plain twin of the kernel, vectorised over tiles and rays; loops
    over chunks and over the 8 steps of the recurrence, in the kernel's
    order of arithmetic."""
    lat = _Lattice(tabs, samp, base, rayt, ke, bank0, prm)
    return march_plain(lat, lambda c: lat.chunk(c)[2])


def march_plain(lat: _Lattice, planes_of) -> torch.Tensor:
    """The emission-absorption recurrence over a tile group's lattice:
    raw heads (T, 5, 16, 16) from ``planes_of(c)``, chunk c's (sigma, r,
    g, b) planes as (T, 256, 8), in the kernels' order of arithmetic."""
    zeros = torch.zeros((lat.t_cnt, RAYS_PER_TILE), dtype=torch.float32,
                        device=lat.dev)
    acc = [zeros] * 5                # r, g, b, w*mid, processed od
    s = zeros
    for c in range(lat.nc):
        sig, cr, cg, cb = planes_of(c)
        livef, dta, mid = lat.chunk_time(c)
        od = torch.clamp_min(sig * dta, 0.0) * livef

        part = [zeros] * 5
        for j in range(GROUP):
            od_j = od[..., j]
            tb = torch.exp(-s)
            p = torch.exp(-(s + od_j))
            procf = livef[..., j] * (tb > lat.stop).to(torch.float32)
            wgt = (tb - p) * procf
            part = [part[0] + wgt * cr[..., j], part[1] + wgt * cg[..., j],
                    part[2] + wgt * cb[..., j], part[3] + wgt * mid[..., j],
                    part[4] + od_j * procf]
            s = s + od_j
        acc = [a + b for a, b in zip(acc, part)]
    return torch.stack(acc, dim=1).reshape(lat.t_cnt, 5, ROWS, RAYS_COLS)


def _tie(x: torch.Tensor) -> torch.Tensor:
    """d max(x, 0) / dx with JAX's tie value 0.5 at x == 0 (torch's relu
    and clamp_min give another value there)."""
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    return torch.where(x > 0.0, one, torch.where(x < 0.0, zero, 0.5 * one))


def _camera_terms(vals, weights, m, dpl):
    """Per-sample d(loss)/d(trilinear fraction) along x, y, z: the
    corner-value differences weighted by the other two axes' weights
    (m folded into z), summed over the four d-planes in the order of
    dvren_tpu's ``_bwd_kernel``. vals (T, 32, 2048); dpl (T, 2048) each."""
    wx, wy, wz = weights
    v = [vals[:, i] for i in range(NCH)]
    dtx = dty = dtz = 0.0
    for ch in range(4):
        dp = dpl[ch]
        vc = v[ch * 8:(ch + 1) * 8]
        for dz in (0, 1):
            for dy in (0, 1):
                dtx = dtx + dp * ((wz[dz] * wy[dy])
                                  * (vc[dz * 4 + dy * 2 + 1]
                                     - vc[dz * 4 + dy * 2]))
        for dz in (0, 1):
            for dx in (0, 1):
                dty = dty + dp * ((wz[dz] * wx[dx])
                                  * (vc[dz * 4 + 2 + dx] - vc[dz * 4 + dx]))
        for dy in (0, 1):
            for dx in (0, 1):
                dtz = dtz + dp * (((m * wy[dy]) * wx[dx])
                                  * (vc[4 + dy * 2 + dx] - vc[dy * 2 + dx]))
    return dtx, dty, dtz


def camera_scales(prm: TileParams) -> tuple:
    """d(fraction)/d(ray coordinate) per axis: float32(inv * ns), the
    factor that chains the fraction adjoint to the ray planes."""
    return tuple(float(torch.tensor(i * n, dtype=torch.float32))
                 for i, n in zip(prm.inv, prm.ns))


def ordered_sums(vals: torch.Tensor, keys: torch.Tensor,
                 n_keys: int) -> torch.Tensor:
    """Rows of ``vals`` (N, C) summed by ``keys`` (N,) into (n_keys, C):
    each key's rows are added one at a time, from +0.0, in their order in
    ``vals``, as K2 adds a window's staged samples; rows with key -1 are
    left out. One step per rank of a row among its key's rows, and within
    a step every key at most once, so the sums are the same on every
    device and every run (no ``index_add_``, whose CUDA atomics add in no
    fixed order)."""
    out = vals.new_zeros((n_keys, vals.shape[1]))
    idx = torch.nonzero(keys >= 0).squeeze(1)
    if idx.numel() == 0:
        return out
    k = keys[idx]
    order = torch.argsort(k, stable=True)
    ks, src = k[order], idx[order]
    pos = torch.arange(ks.numel(), device=ks.device)
    start = torch.ones_like(ks, dtype=torch.bool)
    start[1:] = ks[1:] != ks[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    by_rank = torch.argsort(rank, stable=True)
    ks, src = ks[by_rank], src[by_rank]
    off = 0
    for cnt in torch.unique_consecutive(rank[by_rank],
                                        return_counts=True)[1].tolist():
        d = ks[off:off + cnt]
        out[d] = out[d] + vals[src[off:off + cnt]]
        off += cnt
    return out


EMITS = ("rows", "banks")


def _check_emit(emit: str, prm: TileParams) -> None:
    if emit not in EMITS:
        raise ValueError(f"emit must be one of {EMITS}, got {emit!r}")
    if emit == "banks" and prm.stencil != "cell":
        raise ValueError("emit='banks' takes the cell stencil only (32 "
                         "columns), as the JAX package's K6 does")


def tile_backward_plain(tabs, samp, base, rayt, ke, bank0, gs,
                        prm: TileParams, cam: bool = False,
                        emit: str = "rows"):
    """Plain twin of K2: (d_rows (T, NB, 128, C), d_rayt (T, 12, 128) or
    None) for the per-ray cotangents ``gs`` (T, 5, 16, 16) of K1's heads;
    with ``emit="banks"`` the first is the bank form (T, NB, 32, 128),
    d_rows transposed.

    Pass 1 recomputes every sample's optical-depth prefix in K1's order.
    Pass 2 walks the chunks and their steps in reverse with the adjoint
    of the telescoped weights (suffix sums of gw * w, the 0.5 tie of
    max(x, 0)), and adds each chunk's d(table) into the tile's banks in
    K2's order: sub-tile by sub-tile, the window's 256 slot rows summed
    from 0 over the samples that take part (live, masked in, not stopped)
    in sample order (:func:`ordered_sums`), then its first half added
    into bank b0 and its second into b1. Samples that do not take part
    carry exact zeros. The camera adjoint is summed per ray in K2's
    order; a supercell sample's is the cell one over its 8 vertices,
    which the JAX kernel's 27-vertex hat-derivative sums equal. Given
    float64 ``tabs``, ``base``, ``rayt`` and ``gs`` it sums in float64:
    the reference that K2's float32 sums are held to within 2e-6 x
    scale."""
    _check_emit(emit, prm)
    lat = _Lattice(tabs, samp, base, rayt, ke, bank0, prm)
    t_cnt, nb, nc, subs = lat.t_cnt, lat.nb, lat.nc, lat.subs
    cols = prm.cols
    g = gs.reshape(t_cnt, 5, RAYS_PER_TILE, 1)
    g_r, g_g, g_b, g_wd, g_odp = (g[:, i] for i in range(5))
    zeros = torch.zeros((t_cnt, RAYS_PER_TILE), dtype=tabs.dtype,
                        device=lat.dev)

    # pass 1: the exclusive optical-depth prefix of every sample
    s, s_pre = zeros, []
    for c in range(nc):
        sig = lat.chunk(c)[2][0]
        livef, dta, _ = lat.chunk_time(c)
        od = torch.clamp_min(sig * dta, 0.0) * livef
        pre = []
        for j in range(GROUP):
            pre.append(s)
            s = s + od[..., j]
        s_pre.append(torch.stack(pre, dim=-1))                # (T, 256, 8)

    # pass 2: the reverse adjoint
    acc = torch.zeros((t_cnt, nb * LANES, cols), dtype=tabs.dtype,
                      device=lat.dev)
    # window row of each (tile, sub-tile, window slot)
    win_base = ((lat.tiles[:, None] * subs + lat.sub_of[None])
                * 2 * LANES)                                  # (T, 2048)
    lanes = torch.arange(LANES, device=lat.dev)
    kcam = camera_scales(prm)
    carry = zeros
    dcam = [zeros] * 6
    for c in reversed(range(nc)):
        vals, weights, (sig, cr, cg, cb), idx2 = lat.chunk(c)
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
        dsig = dod * livef * _tie(x) * dta
        dpl = [d.reshape(t_cnt, CHUNK_SAMPLES)
               for d in (dsig, g_r * w, g_g * w, g_b * w)]

        wp = lat.slot_products(c, weights, dpl)             # (T, C, 2048)
        m = lat.m_all[:, c]
        takes_part = ((m > 0) & (procf.reshape(t_cnt, CHUNK_SAMPLES) > 0)
                      & (idx2 >= 0) & (idx2 < 2 * LANES))
        keys = torch.where(takes_part, win_base + idx2, -1)
        win = ordered_sums(wp.transpose(1, 2).reshape(-1, cols),
                           keys.reshape(-1), t_cnt * subs * 2 * LANES)
        win = win.reshape(t_cnt, subs, 2 * LANES, cols)
        b0s = lat.b0_all[:, c]                              # (T, subs)
        for sub in range(subs):
            b0 = b0s[:, sub]
            b1 = torch.clamp(b0 + 1, max=nb - 1)
            for half, bank in enumerate((b0, b1)):
                rows = bank[:, None] * LANES + lanes          # (T, 128)
                acc[lat.tiles[:, None], rows] = (
                    acc[lat.tiles[:, None], rows]
                    + win[:, sub, half * LANES:(half + 1) * LANES])

        if cam:
            st = lat.st_all[:, c]
            terms = _camera_terms(lat.corner_values(vals, c), weights, m,
                                  dpl)
            per = [terms[ax] * kcam[ax] for ax in range(3)] + [
                (terms[ax] * st) * kcam[ax] for ax in range(3)]
            per = [t.reshape(t_cnt, RAYS_PER_TILE, GROUP) for t in per]
            for j in reversed(range(GROUP)):
                dcam = [d + t[..., j] for d, t in zip(dcam, per)]

    d_rows = acc.reshape(t_cnt, nb, LANES, cols)
    if emit == "banks":
        d_rows = d_rows.transpose(2, 3).contiguous()
    d_rayt = (torch.stack(dcam, dim=1).reshape(t_cnt, RAYT_ROWS, LANES)
              if cam else None)
    return d_rows, d_rayt


def tile_backward_set_plain(tabs, tiles: TileSet, gs, prm: TileParams,
                            cam: bool = False, emit: str = "rows",
                            rayt=None):
    """:func:`tile_backward_plain` group by group: the table gradients
    concatenated, (S_b, 128, C) slot rows or (S_b, 32, 128) bank blocks,
    and d(rayt) (T, 12, 128) or None."""
    _check_emit(emit, prm)
    parts, d_rayts, t0 = [], [], 0
    for a, p in zip(tiles.group_views(tabs, rayt), _group_params(tiles, prm)):
        n = int(a[0].shape[0])
        d_part, d_rayt = tile_backward_plain(
            *a, gs[t0:t0 + n].contiguous(), p, cam, emit)
        parts.append(d_part.reshape((-1,) + tuple(d_part.shape[2:])))
        d_rayts.append(d_rayt)
        t0 += n
    tail = (prm.cols, LANES) if emit == "banks" else (LANES, prm.cols)
    rows = torch.cat(parts) if parts else tabs.new_zeros((0,) + tail)
    d_rayt = None
    if cam:
        d_rayt = (torch.cat(d_rayts) if d_rayts
                  else tabs.new_zeros((0, RAYT_ROWS, LANES)))
    return rows, d_rayt


def tile_backward(tabs, tiles: TileSet, gs, prm: TileParams,
                  cam: bool = False, emit: str = "rows", rayt=None):
    """K2 over every tile group of a schedule in one launch: (d_rows
    (S_b, 128, C) f32, the slot rows of every group in group order, row
    b * 128 + lane of flat bank b, column ch * 8 + corner (C = 32) or
    ch * 27 + vertex (C = 108, a supercell schedule), the buffer
    :func:`gather_plan.slot_rows_to_table` reads; with ``cam`` d(rayt)
    (T, 12, 128) in rayt's layout, else None). ``emit="banks"`` (cell
    stencil) gives the table gradient as bank blocks (S_b, 32, 128): the
    same values, transposed per bank, bit for bit.

    ``gs`` (T, 5, 16, 16) f32 is the cotangent of :func:`tile_forward`'s
    output, ``rayt`` the ray planes it was given. CPU tensors run
    :func:`tile_backward_plain` group by group."""
    _check_emit(emit, prm)
    check_tiles(tabs, tiles, prm.cols, prm.subs, rayt, extra={
        "gs": (gs, (tiles.n_tiles, 5, ROWS, RAYS_COLS), torch.float32)})
    rayt = tiles.rayt if rayt is None else rayt
    if tabs.device.type == "cpu":
        return tile_backward_set_plain(tabs, tiles, gs, prm, cam, emit, rayt)
    t_cnt, s_b, dev = tiles.n_tiles, tiles.n_bank_rows, tabs.device
    banks = emit == "banks"
    d_rows = torch.empty((s_b, prm.cols, LANES) if banks
                         else (s_b, LANES, prm.cols),
                         dtype=torch.float32, device=dev)
    d_rayt = (torch.empty((t_cnt, RAYT_ROWS, LANES), dtype=torch.float32,
                          device=dev) if cam else None)
    # each sample's optical-depth prefix, written by pass 1, read by pass 2
    s_pre = torch.empty((tiles.n_chunk_rows * GROUP, RAYS_PER_TILE),
                        dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_tile_backward(
            tabs.data_ptr(), tiles.samp.data_ptr(), tiles.base.data_ptr(),
            rayt.data_ptr(), tiles.ke.data_ptr(), tiles.bank0.data_ptr(),
            tiles.desc.data_ptr(), tiles.order.data_ptr(), gs.data_ptr(),
            d_rows.data_ptr(),
            d_rayt.data_ptr() if cam else None, s_pre.data_ptr(),
            t_cnt, prm.k_max, prm.subs, int(prm.stencil == "super"),
            int(banks), prm.dt, prm.t_near, prm.t_far, prm.t_stop, prm.stop,
            *prm.lo, *prm.inv, *prm.ns, *camera_scales(prm),
            _build.stream_ptr(dev))
    _build.check(code, "dvt_tile_backward")
    tile_backward.launches += 1
    return d_rows, d_rayt


tile_backward.launches = 0
