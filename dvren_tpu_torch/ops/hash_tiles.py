"""Fused hash-MLP tile forward (K7f) and backward (K7b): the hash field's
fast path.

Counterpart of ``dvren_tpu/ops/hash_tiles.py``: the Pallas
``_fwd_kernel`` becomes ``csrc/hash_tiles.cu`` (one block per 16x16 tile)
and ``_bwd_kernel`` becomes ``csrc/hash_tiles_bwd.cu`` (a tile's rays
over one to eight blocks, each warp on its own), one thread per ray,
with the plain PyTorch twins :func:`hash_tile_forward_plain` and
:func:`hash_tile_backward_plain` beside them. The whole pipeline of a
sample (hash encoding, trilinear feature interpolation, both MLP heads,
the transmittance recurrence with exact early stop) runs inside the
kernel: the schedule is only the frame's tile layout.

The TPU's (8, 128) table block (``table_block``) and its lane gathers
have no counterpart: both kernels hold the (L, T, F) table as it is in
shared memory. The MLP head parameters travel as one packed scalar vector
(:func:`pack_mlp_scalars`, offsets :func:`_mlp_layout`), which the
kernels copy into feature-major rows of their own. K7b writes partial
gradients (per block in the table's (L, T, F) order, per warp in the
packed scalar order); :func:`hash_tile_backward` sums them and
:func:`grads_from_blocks` maps them to the params dict.

:func:`hash_tile_forward` and :func:`hash_tile_backward` launch their
kernels for CUDA tensors and run the plain twins for CPU tensors; their
``.launches`` attributes count launches. :func:`processed_steps` counts
the samples the kernels process (each ray's steps before its stop);
:func:`kernel_occupancy` reads the kernels' resources from the runtime.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops.fused_tiles import (CHUNK_SAMPLES, GROUP, LANES,
                                             RAYS_COLS, RAYS_PER_TILE,
                                             RAYT_ROWS, ROWS, _tie)
from dvren_tpu_torch.ops.hashmlp import (HashMLPSpec, encode_planes,
                                         hash_coords, heads_from_planes,
                                         level_resolutions)
from dvren_tpu_torch.ops.integrate import STOP_THRESHOLD

# the params-dict keys in the packed scalar order, after the table
MLP_KEYS = ("sigma_w1", "sigma_b1", "sigma_w2", "sigma_b2",
            "color_w1", "color_b1", "color_w2", "color_b2")


def fast_path_ok(spec: HashMLPSpec) -> bool:
    t = spec.table_size
    return (0 < t <= 128 and (t & (t - 1)) == 0
            and spec.encoding_dim <= 64
            and spec.hidden_dim <= 8)


def _mlp_layout(spec: HashMLPSpec) -> dict:
    """Offsets into the packed MLP scalar vector, and its length."""
    enc, hid = spec.encoding_dim, spec.hidden_dim
    o, i = {}, 0
    for name, n in (("sw1", hid * enc), ("sb1", hid), ("sw2", hid),
                    ("sb2", 1), ("cw1", hid * enc), ("cb1", hid),
                    ("cw2", 3 * hid), ("cb2", 3)):
        o[name] = i
        i += n
    o["total"] = i
    return o


def pack_mlp_scalars(params: dict, spec: HashMLPSpec) -> torch.Tensor:
    """The MLP head parameters (all but the table) as one (P,) f32 vector
    in :func:`_mlp_layout` order."""
    return torch.cat([params[k].reshape(-1) for k in MLP_KEYS]).to(
        torch.float32)


def _mlp_from_scalars(sc: torch.Tensor, spec: HashMLPSpec) -> dict:
    """Views of the packed scalar vector under the params-dict keys."""
    enc, hid = spec.encoding_dim, spec.hidden_dim
    shapes = ((hid, enc), (hid,), (hid,), (), (hid, enc), (hid,), (3, hid),
              (3,))                                      # MLP_KEYS order
    parts = torch.split(sc, [math.prod(s) for s in shapes])
    return {k: v.reshape(s) for k, v, s in zip(MLP_KEYS, parts, shapes)}


def grads_from_blocks(dtab: torch.Tensor, dmlp: torch.Tensor,
                      spec: HashMLPSpec) -> dict:
    """The params-dict cotangent from K7b's summed outputs: ``dtab`` in
    the table's (L, T, F) order (any shape of that size) and ``dmlp``
    (P,) in :func:`_mlp_layout` order."""
    out = _mlp_from_scalars(dmlp, spec)
    out["hash_table"] = dtab.reshape(spec.n_levels, spec.table_size,
                                     spec.features_per_level)
    return out


@dataclass(frozen=True)
class HashTileParams:
    """Static constants of one hash tile group (the JAX op key): the
    chunk count, the lattice, the stop threshold, the spec and its
    float32 level resolutions."""

    n_chunks: int
    dt: float
    t_near: float
    t_far: float
    k_max: int
    stop: float
    spec: HashMLPSpec
    resolutions: tuple

    @property
    def t_stop(self) -> float:
        """End of the depth cursor: min(t_far, t_near + k_max * dt)."""
        return min(float(self.t_far),
                   float(self.t_near) + float(self.k_max) * float(self.dt))


def hash_tile_params(plan: Plan, spec: HashMLPSpec,
                     n_chunks: int) -> HashTileParams:
    return HashTileParams(
        n_chunks=int(n_chunks), dt=float(plan.sampling.dt),
        t_near=float(plan.t_near), t_far=float(plan.t_far),
        k_max=int(plan.sampling.max_steps), stop=float(STOP_THRESHOLD),
        spec=spec, resolutions=level_resolutions(spec))


def _check_inputs(samp, rayt, table, sc, prm: HashTileParams, extra=()):
    spec = prm.spec
    t_cnt = samp.shape[0]
    want = {
        "samp": (samp, (t_cnt, prm.n_chunks, ROWS, LANES)),
        "rayt": (rayt, (t_cnt, RAYT_ROWS, LANES)),
        "table": (table, (spec.n_levels, spec.table_size,
                          spec.features_per_level)),
        "sc": (sc, (_mlp_layout(spec)["total"],)),
    }
    for name, x, shape in extra:
        want[name] = (x, shape)
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: want torch.float32, got {x.dtype}")
        if x.device != samp.device:
            raise ValueError(f"{name} on {x.device}, samp on {samp.device}")
    if samp.device.type == "cuda":
        for name, (x, _) in want.items():
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif samp.device.type != "cpu":
        raise ValueError(f"unsupported device {samp.device}")


def _kernel_args(prm: HashTileParams):
    spec = prm.spec
    res = (ctypes.c_float * len(prm.resolutions))(*prm.resolutions)
    return res, (prm.n_chunks, prm.k_max, spec.n_levels,
                 spec.features_per_level, spec.table_size, spec.hidden_dim,
                 prm.dt, prm.t_near, prm.t_far, prm.t_stop, prm.stop)


def hash_tile_forward(samp, rayt, table, sc,
                      prm: HashTileParams) -> torch.Tensor:
    """K7f: one tile group's raw heads, (T, 5, 16, 16) float32 (r, g, b,
    weighted mid-depth, processed optical depth).

    samp (T, nc, 16, 128) f32 sample_t, rayt (T, 12, 128) f32, table
    (L, T, F) f32, sc (P,) f32 packed MLP scalars."""
    _check_inputs(samp, rayt, table, sc, prm)
    if samp.device.type == "cpu":
        return hash_tile_forward_plain(samp, rayt, table, sc, prm)
    t_cnt = int(samp.shape[0])
    out = torch.empty((t_cnt, 5, ROWS, RAYS_COLS), dtype=torch.float32,
                      device=samp.device)
    res, consts = _kernel_args(prm)
    lib = _build.library()
    with torch.cuda.device(samp.device):
        code = lib.dvt_hash_forward(
            samp.data_ptr(), rayt.data_ptr(), table.data_ptr(),
            sc.data_ptr(), out.data_ptr(), t_cnt, *consts,
            ctypes.cast(res, ctypes.c_void_p),
            _build.stream_ptr(samp.device))
    _build.check(code, "dvt_hash_forward")
    hash_tile_forward.launches += 1
    return out


hash_tile_forward.launches = 0


class _Steps:
    """The twins' per-chunk inputs in the kernels' order of arithmetic:
    sample positions (T, 2048) per axis and the lattice geometry."""

    def __init__(self, samp, rayt, prm: HashTileParams):
        self.t_cnt, self.nc = int(samp.shape[0]), prm.n_chunks
        self.prm, self.samp = prm, samp
        dev = self.dev = samp.device

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        self.dt, self.t_near, self.t_far = (f32(prm.dt), f32(prm.t_near),
                                            f32(prm.t_far))
        self.t_stop, self.stop = f32(prm.t_stop), f32(prm.stop)
        self.rays = rayt.reshape(self.t_cnt, 6, RAYS_PER_TILE) \
            .repeat_interleave(GROUP, dim=2)                   # (T, 6, 2048)
        self.step = torch.arange(CHUNK_SAMPLES, device=dev) % GROUP

    def positions(self, c):
        st = self.samp[:, c].reshape(self.t_cnt, CHUNK_SAMPLES)
        return [self.rays[:, ax] + self.rays[:, 3 + ax] * st
                for ax in range(3)]

    def time(self, c):
        """(livef, dt_actual, mid-segment depth) of chunk c's steps, each
        (1, 256, 8): the lattice starts at step 0 in every tile."""
        k = c * GROUP + self.step
        base_t = self.t_near + k.to(torch.float32) * self.dt
        live = (base_t < self.t_far) & (k < self.prm.k_max)
        dta = torch.where(live,
                          torch.minimum(base_t + self.dt, self.t_far) - base_t,
                          torch.zeros_like(base_t))
        tcur = self.t_near + torch.clamp_min(
            torch.minimum(base_t, self.t_stop)
            - torch.minimum(self.t_near, self.t_stop), 0.0)
        shape = (1, RAYS_PER_TILE, GROUP)
        return (live.to(torch.float32).reshape(shape), dta.reshape(shape),
                (tcur + 0.5 * dta).reshape(shape))

    def planes(self, c, table, mlp):
        """Chunk c: (sigma, r, g, b) as (T, 256, 8), the encoding planes
        and the heads' pre-activations."""
        px, py, pz = self.positions(c)
        enc = encode_planes(px, py, pz, table, self.prm.spec)
        out, pre = heads_from_planes(enc, mlp)
        shape = (self.t_cnt, RAYS_PER_TILE, GROUP)
        return [o.reshape(shape) for o in out], enc, pre, (px, py, pz)


def hash_tile_forward_plain(samp, rayt, table, sc, prm: HashTileParams,
                            return_counts: bool = False):
    """Plain twin of K7f, vectorised over tiles and rays; loops over
    chunks and over the 8 steps of the recurrence, in the kernel's order
    of arithmetic. With ``return_counts`` also each ray's count of
    processed steps, (T, 256) int64: the steps whose weight the
    recurrence takes (live, and T before the step above ``stop``)."""
    steps = _Steps(samp, rayt, prm)
    mlp = _mlp_from_scalars(sc, prm.spec)
    zeros = torch.zeros((steps.t_cnt, RAYS_PER_TILE), dtype=torch.float32,
                        device=steps.dev)
    acc = [zeros] * 5                # r, g, b, w*mid, processed od
    s = zeros
    count = torch.zeros_like(zeros, dtype=torch.int64)
    for c in range(steps.nc):
        (sig, cr, cg, cb), _, _, _ = steps.planes(c, table, mlp)
        livef, dta, mid = steps.time(c)
        od = torch.clamp_min(sig * dta, 0.0) * livef
        part = [zeros] * 5
        for j in range(GROUP):
            od_j = od[..., j]
            tb = torch.exp(-s)
            p = torch.exp(-(s + od_j))
            procf = livef[..., j] * (tb > steps.stop).to(torch.float32)
            wgt = (tb - p) * procf
            part = [part[0] + wgt * cr[..., j], part[1] + wgt * cg[..., j],
                    part[2] + wgt * cb[..., j], part[3] + wgt * mid[..., j],
                    part[4] + od_j * procf]
            count += (procf > 0).to(torch.int64)
            s = s + od_j
        acc = [a + b for a, b in zip(acc, part)]
    out = torch.stack(acc, dim=1).reshape(steps.t_cnt, 5, ROWS, RAYS_COLS)
    return (out, count) if return_counts else out


def processed_steps(samp, rayt, table, sc, prm: HashTileParams):
    """Each ray's processed steps, (T, 256) int64: the samples K7f and K7b
    run (K7b's pass-1 bound, ``k_stop``), from the sigma head's optical-
    depth prefix. A ray stops at its first step whose transmittance
    before it is at most ``stop``, or at the end of its live lattice (the
    lattice is live up to a step, the same for every ray); every step
    from there adds nothing. Runs on the tensors' device."""
    steps = _Steps(samp, rayt, prm)
    mlp = _mlp_from_scalars(sc, prm.spec)
    s = torch.zeros((steps.t_cnt, RAYS_PER_TILE), dtype=torch.float32,
                    device=steps.dev)
    going = torch.ones_like(s, dtype=torch.bool)
    count = torch.zeros_like(s, dtype=torch.int64)
    for c in range(steps.nc):
        sig = steps.planes(c, table, mlp)[0][0]
        livef, dta, _ = steps.time(c)
        od = torch.clamp_min(sig * dta, 0.0)
        for j in range(GROUP):
            going &= (livef[..., j] > 0) & (torch.exp(-s) > steps.stop)
            count += going.to(torch.int64)
            s = s + od[..., j]
    return count


def hash_tile_backward_plain(samp, rayt, table, sc, gs,
                             prm: HashTileParams):
    """Plain twin of K7b: (d_table (L, T, F), d_mlp (P,)) for the per-ray
    cotangents ``gs`` (T, 5, 16, 16) of K7f's heads.

    Pass 1 recomputes every sample's optical-depth prefix in K7f's order.
    Pass 2 walks the chunks and their steps in reverse with the adjoint of
    the telescoped weights (suffix sums of gw * w), then through both
    heads with JAX's tie values written out (0.5 at max(x, 0) == 0 and at
    each end of the colour clamp; torch's relu and clamp backward give
    other values there). The MLP gradients are matrix products over the
    chunk's samples; the table gradient is ``index_add_`` per level and
    corner into a float64 accumulator (in float32 the card's
    ``index_add_``, a chain of atomics in no fixed order over the frame's
    millions of terms, rounds more than K7b's per-warp sums: 1.5e-5 x
    scale against 3.9e-7 on an H100, at the fit of
    ``tools/hashmlp_bench.py``).
    Per-sample values follow the kernel's order of arithmetic; the sums
    over samples run in another order."""
    spec = prm.spec
    steps = _Steps(samp, rayt, prm)
    mlp = _mlp_from_scalars(sc, spec)
    t_cnt, dev = steps.t_cnt, steps.dev
    hid, n_f, t_size = spec.hidden_dim, spec.features_per_level, \
        spec.table_size
    g = gs.reshape(t_cnt, 5, RAYS_PER_TILE, 1)
    g_r, g_g, g_b, g_wd, g_odp = (g[:, i] for i in range(5))
    zeros = torch.zeros((t_cnt, RAYS_PER_TILE), dtype=torch.float32,
                        device=dev)

    # pass 1: the exclusive optical-depth prefix of every sample
    s, s_pre = zeros, []
    for c in range(steps.nc):
        sig = steps.planes(c, table, mlp)[0][0]
        livef, dta, _ = steps.time(c)
        od = torch.clamp_min(sig * dta, 0.0) * livef
        pre = []
        for j in range(GROUP):
            pre.append(s)
            s = s + od[..., j]
        s_pre.append(torch.stack(pre, dim=-1))                # (T, 256, 8)

    # pass 2: the reverse adjoint
    d_table = torch.zeros((spec.n_levels, t_size * n_f),
                          dtype=torch.float64, device=dev)
    d_mlp = {k: torch.zeros_like(v) for k, v in mlp.items()}
    carry = zeros
    for c in reversed(range(steps.nc)):
        (sig, cr, cg, cb), enc, pre, pos = steps.planes(c, table, mlp)
        s_pre1, s_pre2, c_pre1, c_pre2, s_h, c_h = pre
        livef, dta, mid = steps.time(c)
        x = sig * dta
        od = torch.clamp_min(x, 0.0) * livef
        tb = torch.exp(-s_pre[c])
        p = torch.exp(-(s_pre[c] + od))
        procf = livef * (tb > steps.stop).to(torch.float32)
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

        dsig = flat(((dod * livef) * _tie(x)) * dta)
        dsig2 = dsig * _tie(s_pre2)
        dc2 = []
        for ch, gc in enumerate((g_r, g_g, g_b)):
            y2 = torch.clamp_min(c_pre2[ch], 0.0)
            t_hi = torch.where(y2 < 1.0, 1.0, torch.where(y2 > 1.0, 0.0, 0.5))
            dc2.append((flat(gc * w) * t_hi) * _tie(c_pre2[ch]))
        ds1 = [(dsig2 * mlp["sigma_w2"][j]) * _tie(s_pre1[j])
               for j in range(hid)]
        dc1 = []
        for j in range(hid):
            dh = dc2[0] * mlp["color_w2"][0, j]
            for ch in (1, 2):
                dh = dh + dc2[ch] * mlp["color_w2"][ch, j]
            dc1.append(dh * _tie(c_pre1[j]))

        def outer(a, b):
            return torch.stack([v.reshape(-1) for v in a]) @ \
                torch.stack([v.reshape(-1) for v in b]).T

        d_mlp["sigma_w1"] += outer(ds1, enc)
        d_mlp["sigma_b1"] += torch.stack(ds1).sum(dim=(1, 2))
        d_mlp["sigma_w2"] += outer([dsig2], s_h)[0]
        d_mlp["sigma_b2"] += dsig2.sum()
        d_mlp["color_w1"] += outer(dc1, enc)
        d_mlp["color_b1"] += torch.stack(dc1).sum(dim=(1, 2))
        d_mlp["color_w2"] += outer(dc2, c_h)
        d_mlp["color_b2"] += torch.stack(dc2).sum(dim=(1, 2))

        px, py, pz = pos
        for level, res in enumerate(prm.resolutions):
            r = torch.tensor(res, dtype=torch.float32, device=dev)
            sx, sy, sz = px * r, py * r, pz * r
            x0, y0, z0 = torch.floor(sx), torch.floor(sy), torch.floor(sz)
            fx, fy, fz = sx - x0, sy - y0, sz - z0
            ix, iy, iz = (v.to(torch.int64) for v in (x0, y0, z0))
            denc = []
            for f in range(n_f):
                i = level * n_f + f
                acc = (ds1[0] * mlp["sigma_w1"][0, i]
                       + dc1[0] * mlp["color_w1"][0, i])
                for j in range(1, hid):
                    acc = acc + (ds1[j] * mlp["sigma_w1"][j, i]
                                 + dc1[j] * mlp["color_w1"][j, i])
                denc.append(acc.reshape(-1))
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                for dy in (0, 1):
                    wy = fy if dy else 1.0 - fy
                    for dx in (0, 1):
                        wx = fx if dx else 1.0 - fx
                        wc = ((wx * wy) * wz).reshape(-1)
                        idx = hash_coords(ix + dx, iy + dy, iz + dz,
                                          t_size).reshape(-1)
                        for f in range(n_f):
                            d_table[level].index_add_(
                                0, idx * n_f + f,
                                (wc * denc[f]).to(torch.float64))
    d_sc = torch.cat([d_mlp[k].reshape(-1) for k in MLP_KEYS])
    return d_table.to(torch.float32).reshape(table.shape), d_sc


def hash_tile_backward(samp, rayt, table, sc, gs, prm: HashTileParams):
    """K7b: (d_table (L, T, F), d_mlp (P,)) for the cotangent ``gs``
    (T, 5, 16, 16) f32 of :func:`hash_tile_forward`'s output.

    Launches ``csrc/hash_tiles_bwd.cu``, which writes partials (d(table)
    per block, d(MLP) per warp), and sums them over their first axis
    (``torch.sum``: a fixed order, so repeat runs are bit-identical) for
    CUDA tensors; runs :func:`hash_tile_backward_plain` for CPU tensors.

    The kernel keeps the (L, T, F) table, a d(table) copy per warp and
    the warps' stage rows in shared memory, with 4, 2 or 1 warps per
    block (whichever keeps the most warps resident on an SM; 8 / warps
    blocks per tile), so it takes every spec :func:`fast_path_ok` admits
    (L*F <= 64 at T=128); a spec that does not fit raises."""
    t_cnt = int(samp.shape[0])
    _check_inputs(samp, rayt, table, sc, prm,
                  extra=(("gs", gs, (t_cnt, 5, ROWS, RAYS_COLS)),))
    if samp.device.type == "cpu":
        return hash_tile_backward_plain(samp, rayt, table, sc, gs, prm)
    spec = prm.spec
    dev = samp.device
    n_sc = int(sc.shape[0])
    warps = kernel_occupancy(spec, dev.index)["hash_tiles_bwd"][
        "warps_per_block"]
    part_tab = torch.empty((t_cnt * (RAYS_PER_TILE // 32 // warps),
                            spec.hash_table_size),
                           dtype=torch.float32, device=dev)
    part_mlp = torch.empty((t_cnt * (RAYS_PER_TILE // 32), n_sc),
                           dtype=torch.float32, device=dev)
    s_pre = torch.empty((t_cnt, prm.n_chunks * GROUP, RAYS_PER_TILE),
                        dtype=torch.float32, device=dev)
    res, consts = _kernel_args(prm)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_hash_backward(
            samp.data_ptr(), rayt.data_ptr(), table.data_ptr(),
            sc.data_ptr(), gs.data_ptr(), part_tab.data_ptr(),
            part_mlp.data_ptr(), s_pre.data_ptr(), t_cnt, *consts,
            ctypes.cast(res, ctypes.c_void_p), _build.stream_ptr(dev))
    _build.check(code, "dvt_hash_backward")
    hash_tile_backward.launches += 1
    return (part_tab.sum(dim=0).reshape(table.shape),
            part_mlp.sum(dim=0))


@functools.lru_cache(maxsize=None)
def _occupancy(n_levels: int, n_feat: int, t_size: int, hidden: int,
               device: int) -> dict:
    lib = _build.library()
    out = {}
    for name, fn, keys in (
            ("hash_tiles", lib.dvt_hash_forward_occupancy,
             ("registers", "static_smem", "local_bytes", "dynamic_smem",
              "blocks_per_sm")),
            ("hash_tiles_bwd", lib.dvt_hash_backward_occupancy,
             ("registers", "static_smem", "local_bytes", "dynamic_smem",
              "blocks_per_sm", "warps_per_block", "tiles_per_lane"))):
        vals = (ctypes.c_int * 8)()
        with torch.cuda.device(device):
            code = fn(n_levels, n_feat, t_size, hidden,
                      ctypes.cast(vals, ctypes.c_void_p))
        _build.check(code, f"{name} occupancy")
        out[name] = dict(zip(keys, list(vals)))
    return out


def kernel_occupancy(spec: HashMLPSpec, device: int | None = None) -> dict:
    """K7f's and K7b's registers, static and dynamic shared memory (bytes
    per block), local memory (bytes per thread: stack and spills) and
    resident blocks per SM at ``spec`` on CUDA device ``device`` (the
    current one by default), from the CUDA runtime; K7b also its warps
    per block and its product tiles per lane."""
    if device is None:
        device = torch.cuda.current_device()
    occ = _occupancy(spec.n_levels, spec.features_per_level,
                     spec.table_size, spec.hidden_dim, int(device))
    return {k: dict(v) for k, v in occ.items()}


hash_tile_backward.launches = 0

_PARAM_ORDER = ("hash_table",) + MLP_KEYS


class _HashGroup(torch.autograd.Function):
    """Hash-field params -> one tile group's raw heads, as one autograd
    node: the counterpart of ``dvren_tpu``'s ``_hash_group`` custom VJP.

    Forward: pack the MLP scalars, K7f. Backward: K7b, then
    :func:`grads_from_blocks`. Returns None for ``static`` and ``samp``,
    a zero cotangent for ``rayt`` when asked (the hash path has no camera
    gradient) and the params' cotangents in ``_PARAM_ORDER``. ``static`` =
    (HashTileParams, use_kernel); on CPU tensors the wrappers run the
    plain twins."""

    @staticmethod
    def forward(ctx, static, samp, rayt, *params):
        prm, use_kernel = static
        named = dict(zip(_PARAM_ORDER, params))
        table = named["hash_table"].contiguous()
        sc = pack_mlp_scalars(named, prm.spec)
        forward = hash_tile_forward if use_kernel else hash_tile_forward_plain
        ctx.static = static
        ctx.save_for_backward(samp, rayt, table, sc)
        return forward(samp, rayt, table, sc, prm)

    @staticmethod
    def backward(ctx, g_raw):
        prm, use_kernel = ctx.static
        samp, rayt, table, sc = ctx.saved_tensors
        backward = (hash_tile_backward if use_kernel
                    else hash_tile_backward_plain)
        d_tab, d_sc = backward(samp, rayt, table, sc, g_raw.contiguous(),
                               prm)
        grads = grads_from_blocks(d_tab, d_sc, prm.spec)
        d_rayt = torch.zeros_like(rayt) if ctx.needs_input_grad[2] else None
        return (None, None, d_rayt, *(grads[k] for k in _PARAM_ORDER))


def render_hash_tile_group_raw(plan: Plan, spec: HashMLPSpec, samp, rayt,
                               params: dict, n_chunks: int,
                               use_kernel: bool = True) -> torch.Tensor:
    """Fused hash-MLP forward for one tile group: (T, 5, 16, 16) raw heads
    (radiance r/g/b, weighted mid-depth, processed optical depth) laid
    out as image tiles. Differentiable in ``params`` (the hash table and
    both MLP heads). ``use_kernel=False`` runs the plain twins on the
    tensors' device."""
    check(fast_path_ok(spec),
          "hash fast path needs a power-of-two table_size <= 128, "
          "hidden_dim <= 8 and encoding_dim <= 64")
    prm = hash_tile_params(plan, spec, n_chunks)
    return _HashGroup.apply((prm, use_kernel), samp, rayt,
                            *(params[k] for k in _PARAM_ORDER))
