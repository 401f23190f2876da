"""Fused tile-group forward (K1) and the helpers around it.

Counterpart of ``dvren_tpu/ops/fused_tiles.py`` for the forward render:
the Pallas ``_fwd_kernel`` becomes the CUDA kernel ``csrc/fused_tiles.cu``
(one thread per ray, one block per 16x16 tile), with the plain PyTorch
twin :func:`tile_forward_plain` beside it. The TPU kernel's layout
machinery (mask-matmul prefix sums, lane-shuffle slot expansion, the
``mxu``/``roll`` ablations) has no counterpart: on the card a ray's
prefix sum is a running sum.

Per sample the kernel recomputes the trilinear fractions from the slim
schedule (sample_t bits, slot | mask bits, the tile's ray planes and the
slot's cell base), interpolates the 32-column stencil row of its slot from
the chunk's two-bank window, and runs the optical-depth recurrence with
exact early stop. Output per ray: r, g, b, sum of w * mid-segment depth,
and processed optical depth, as (T, 5, 16, 16) image tiles.

:func:`tile_forward` launches the kernel for CUDA tensors and runs the
plain twin for CPU tensors; ``tile_forward.launches`` counts launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.ops.integrate import OPACITY_EPS, STOP_THRESHOLD

ROWS = 16          # block rows per chunk
LANES = 128        # lanes per row (slots per bank)
GROUP = 8          # steps per chunk (lanes per ray)
RAYS_PER_TILE = 256
RAYS_COLS = 16     # output lanes per block row
NCH = 32           # packed columns: 4 (sigma, r, g, b) x 8 corners
RAYT_ROWS = 12     # compact ray planes: 6 axes x 2 halves of 128 rays
CHUNK_SAMPLES = ROWS * LANES


@dataclass(frozen=True)
class TileParams:
    """Static constants of one tile group's forward (the port's
    ``tile_op_params``): chunk and bank counts, the lattice, and the
    fraction constants lo / inv / ns per axis (x, y, z)."""

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

    @property
    def t_stop(self) -> float:
        """End of the depth cursor: min(t_far, t_near + k_max * dt)."""
        return min(float(self.t_far),
                   float(self.t_near) + float(self.k_max) * float(self.dt))


def tile_op_params(plan: Plan, geom, nb: int, n_chunks: int) -> TileParams:
    """Group constants from the plan and the schedule's field geometry
    ``geom = (bbox_min, bbox_max, grid_shape_zyx)``; computed in float64
    and rounded to float32 where they are used, as in the JAX package."""
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
        stop=float(STOP_THRESHOLD), lo=lo, inv=inv, ns=ns)


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


def _check_inputs(tabs, samp, base, rayt, ke, bank0, prm: TileParams):
    t_cnt = tabs.shape[0]
    nc, nb = prm.n_chunks, prm.banks
    want = {
        "tabs": (tabs, (t_cnt, nb, NCH, LANES), torch.float32),
        "samp": (samp, (t_cnt, nc, 3, ROWS, LANES), torch.uint16),
        "base": (base, (t_cnt, nb, 3, LANES), torch.float32),
        "rayt": (rayt, (t_cnt, RAYT_ROWS, LANES), torch.float32),
        "ke": (ke, (t_cnt,), torch.int32),
        "bank0": (bank0, (t_cnt * nc,), torch.int32),
    }
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: want shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: want {dtype}, got {x.dtype}")
        if x.device != tabs.device:
            raise ValueError(f"{name} on {x.device}, tabs on {tabs.device}")


def tile_forward(tabs, samp, base, rayt, ke, bank0,
                 prm: TileParams) -> torch.Tensor:
    """One tile group's raw heads, (T, 5, 16, 16) float32.

    tabs (T, NB, 32, 128) f32, samp (T, nc, 3, 16, 128) u16, base
    (T, NB, 3, 128) f32, rayt (T, 12, 128) f32, ke (T,) i32, bank0
    (T * nc,) i32."""
    _check_inputs(tabs, samp, base, rayt, ke, bank0, prm)
    if tabs.device.type == "cpu":
        return tile_forward_plain(tabs, samp, base, rayt, ke, bank0, prm)
    if tabs.device.type != "cuda":
        raise ValueError(f"unsupported device {tabs.device}")
    for name, x in (("tabs", tabs), ("samp", samp), ("base", base),
                    ("rayt", rayt), ("ke", ke), ("bank0", bank0)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t_cnt = int(tabs.shape[0])
    out = torch.empty((t_cnt, 5, ROWS, RAYS_COLS), dtype=torch.float32,
                      device=tabs.device)
    lib = _build.library()
    with torch.cuda.device(tabs.device):
        code = lib.dvt_tile_forward(
            tabs.data_ptr(), samp.data_ptr(), base.data_ptr(),
            rayt.data_ptr(), ke.data_ptr(), bank0.data_ptr(), out.data_ptr(),
            t_cnt, prm.n_chunks, prm.banks, prm.k_max,
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
    and the tile-local lane (int32). Sample q = ray * 8 + step of a chunk
    sits at block row q // 128, lane q % 128, so the flat view needs no
    shuffle. torch has no shifts or masks on uint16: widen first."""
    t_cnt, nc = samp.shape[:2]
    s32 = samp.to(torch.int32).reshape(t_cnt, nc, 3, CHUNK_SAMPLES)
    st = ((s32[:, :, 0] << 16) | s32[:, :, 1]).view(torch.float32)
    m = ((s32[:, :, 2] >> 15) & 1).to(torch.float32)
    return st, m, s32[:, :, 2] & 0x7FFF


def tile_forward_plain(tabs, samp, base, rayt, ke, bank0,
                       prm: TileParams) -> torch.Tensor:
    """Plain twin of the kernel, vectorised over tiles and rays; loops
    over chunks and over the 8 steps of the recurrence, in the kernel's
    order of arithmetic."""
    t_cnt, nb = int(tabs.shape[0]), prm.banks
    nc = prm.n_chunks
    dev = tabs.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    dt, t_near, t_far = f32(prm.dt), f32(prm.t_near), f32(prm.t_far)
    t_stop, stop = f32(prm.t_stop), f32(prm.stop)
    lo = [f32(v) for v in prm.lo]
    inv = [f32(v) for v in prm.inv]
    ns = [f32(v) for v in prm.ns]

    st_all, m_all, lane_all = decode_samples(samp)
    rays = rayt.reshape(t_cnt, 6, RAYS_PER_TILE).repeat_interleave(
        GROUP, dim=2)                                  # (T, 6, 2048)
    b0_all = (bank0.reshape(t_cnt, nc) & 0x3FFF).long()
    tiles = torch.arange(t_cnt, device=dev)
    step = (torch.arange(CHUNK_SAMPLES, device=dev) % GROUP)[None]
    ke32 = ke.to(torch.int32)
    t_origin = t_near + ke32.to(torch.float32) * dt            # (T,)
    t_origin_c = torch.minimum(t_origin, t_stop)

    zeros = torch.zeros((t_cnt, RAYS_PER_TILE), dtype=torch.float32,
                        device=dev)
    acc = [zeros] * 5                # r, g, b, w*mid, processed od
    s = zeros
    for c in range(nc):
        b0 = b0_all[:, c]
        b1 = torch.clamp(b0 + 1, max=nb - 1)
        idx2 = lane_all[:, c] - (b0 * LANES)[:, None].to(torch.int32)
        i0 = idx2.clamp(0, LANES - 1).long()
        i1 = (idx2 - LANES).clamp(0, LANES - 1).long()
        second = idx2 >= LANES

        def expand(m0, m1):
            # (T, C, 128) bank rows -> (T, C, 2048) per-sample values
            n = m0.shape[1]
            v0 = torch.gather(m0, 2, i0[:, None].expand(t_cnt, n, -1))
            v1 = torch.gather(m1, 2, i1[:, None].expand(t_cnt, n, -1))
            return torch.where(second[:, None], v1, v0)

        vals = expand(tabs[tiles, b0], tabs[tiles, b1])      # (T, 32, 2048)
        cbase = expand(base[tiles, b0], base[tiles, b1])     # (T, 3, 2048)

        st, m = st_all[:, c], m_all[:, c]
        w = []
        for ax in range(3):
            p = rays[:, ax] + rays[:, 3 + ax] * st
            frac = ((p - lo[ax]) * inv[ax]) * ns[ax] - cbase[:, ax]
            w.append((1.0 - frac, frac))
        wx, wy, wz = w
        wz = (m * wz[0], m * wz[1])
        w8 = [wz[dz] * wy[dy] * wx[dx]
              for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        planes = []
        for ch in range(4):
            a = w8[0] * vals[:, ch * 8]
            for corner in range(1, 8):
                a = a + w8[corner] * vals[:, ch * 8 + corner]
            planes.append(a.reshape(t_cnt, RAYS_PER_TILE, GROUP))
        sig, cr, cg, cb = planes

        k = ke32[:, None] + c * GROUP + step                 # (T, 2048)
        base_t = t_near + k.to(torch.float32) * dt
        live = (base_t < t_far) & (k < prm.k_max)
        livef = live.to(torch.float32)
        dta = torch.where(live, torch.minimum(base_t + dt, t_far) - base_t,
                          torch.zeros_like(base_t))
        tcur = t_origin[:, None] + torch.clamp_min(
            torch.minimum(base_t, t_stop) - t_origin_c[:, None], 0.0)
        mid = tcur + 0.5 * dta
        livef, dta, mid = (x.reshape(t_cnt, RAYS_PER_TILE, GROUP)
                           for x in (livef, dta, mid))
        od = torch.clamp_min(sig * dta, 0.0) * livef

        part = [zeros] * 5
        for j in range(GROUP):
            od_j = od[..., j]
            tb = torch.exp(-s)
            p = torch.exp(-(s + od_j))
            procf = livef[..., j] * (tb > stop).to(torch.float32)
            wgt = (tb - p) * procf
            part = [part[0] + wgt * cr[..., j], part[1] + wgt * cg[..., j],
                    part[2] + wgt * cb[..., j], part[3] + wgt * mid[..., j],
                    part[4] + od_j * procf]
            s = s + od_j
        acc = [a + b for a, b in zip(acc, part)]
    return torch.stack(acc, dim=1).reshape(t_cnt, 5, ROWS, RAYS_COLS)
