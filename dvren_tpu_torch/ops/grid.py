"""Full-pitch packed trilinear stencil: row count and plain shift stack.

Counterpart of ``fullpitch_rows`` and ``_shift_stack_fullpitch`` in
``dvren_tpu/ops/grid.py``. The packed table has one row per grid cell v =
(iz*Y + iy)*X + ix (full grid pitch) and 32 columns ``ch*8 + corner``
with ``corner = dz*4 + dy*2 + dx`` over the channels (sigma, r, g, b).
At full pitch every column is the flattened channel plane shifted by the
pure offset ``dz*Y*X + dy*X + dx``, zero past the end. Rows of cells on
the far faces (ix == X-1 and so on) read wrapped neighbours and are never
named by a schedule.

The table itself is built by the CUDA kernels in
:mod:`dvren_tpu_torch.ops.packed_transpose` (float32, or a 16-bit type
named by :func:`table_dtype`); the stack here is the plain half of those
kernels' twins, and :func:`stack_plane_grads`, its adjoint, is the plain
twin of the table-gradient unpacks there.

Point evaluation (counterpart of ``eval_grid_planes``,
``build_packed_stencil`` and ``eval_packed_trilinear`` there) serves the
per-ray paths: :func:`eval_grid_planes` (nearest or trilinear, zero or
clamp outside the bbox) and the packed trilinear stencil, one 32-value
row gathered per sample. Every gather goes through :func:`take_rows`,
whose backward adds the rows' cotangents by a sort-based segment sum
(:func:`accumulate_rows`: each row's cotangents summed in a fixed order):
no float atomics in a run-dependent order and no global switch, so repeat
backwards are bit-identical on the card. On the card the packed stencil's
evaluation and adjoint are kernels (:mod:`dvren_tpu_torch.ops.packed_eval`);
:func:`eval_packed_trilinear`'s torch code is their twin.
"""

from __future__ import annotations

import torch

from dvren_tpu_torch.core.plan import InterpMode, OobPolicy
from dvren_tpu_torch.core.status import DvrenError
from dvren_tpu_torch.ops import packed_eval
from dvren_tpu_torch.utils import trace

NCH = 32     # packed columns: 4 channels x 8 corners

TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def table_dtype(packed_dtype: str) -> torch.dtype:
    """A field's ``packed_dtype`` name -> the packed table's torch dtype:
    "float32" (the parity default), "bfloat16" or "float16" (the 16-bit
    flat-table route of the tiled renderer)."""
    try:
        return TABLE_DTYPES[packed_dtype]
    except KeyError:
        raise DvrenError.invalid_argument(
            f"unknown packed_dtype {packed_dtype!r}; expected float32, "
            "bfloat16 or float16") from None


def fullpitch_rows(grid_shape_zyx) -> int:
    """Full-pitch packed-table row count: Z*Y*X rounded up to 2048 (the
    JAX package's transpose block; kept so tables compare row for row)."""
    z, y, x = (int(v) for v in grid_shape_zyx)
    return -(-(z * y * x) // 2048) * 2048


def corner_offsets(grid_shape_zyx) -> list[int]:
    """Flat source offset of each packed corner, in corner order."""
    _, y, x = (int(v) for v in grid_shape_zyx)
    return [dz * y * x + dy * x + dx
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


def _shift_stack_fullpitch(sigma: torch.Tensor, color: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """(32, n_rows) column-major full-pitch stencil stack: column
    ch*8 + corner is channel plane ch at offset ``corner_offsets[corner]``,
    zero-padded past the grid."""
    z, y, x = sigma.shape
    p = z * y * x
    offs = corner_offsets(sigma.shape)
    pad = n_rows + offs[-1] - p
    planes = [sigma.reshape(-1)] + [color[..., i].reshape(-1)
                                    for i in range(3)]
    parts = []
    for plane in planes:
        flat = torch.cat([plane.to(torch.float32),
                          plane.new_zeros(max(pad, 0), dtype=torch.float32)])
        for off in offs:
            parts.append(flat[off:off + n_rows])
    return torch.stack(parts, dim=0)


SUPER_NCH = 108   # supercell columns: 4 channels x 27 vertices


def supercell_dims(grid_shape_zyx) -> tuple:
    """Supergrid dims (SZ, SY, SX) of the 2x2x2 supercells of base cells:
    base cells run [0, n-2] per axis, so supercell cell // 2 runs
    [0, (n-2) // 2] and n // 2 covers it for every n >= 2."""
    z, y, x = (int(v) for v in grid_shape_zyx)
    return (z // 2, y // 2, x // 2)


def supercell_rows(grid_shape_zyx) -> int:
    sz, sy, sx = supercell_dims(grid_shape_zyx)
    return sz * sy * sx


def build_supercell_stencil(sigma: torch.Tensor,
                            color: torch.Tensor) -> torch.Tensor:
    """The 3x3x3 vertex block of every 2x2x2 supercell: (R_s, 108) float32
    with R_s = :func:`supercell_rows`, row (sz*SY + sy)*SX + sx, column
    ch*27 + vz*9 + vy*3 + vx (ch in sigma, r, g, b; vertex v at grid point
    2s + v per axis), as ``dvren_tpu/ops/grid.py::build_supercell_stencil``
    builds it. Vertices past the grid (the last supercell of an even axis)
    are zero: every sample that could read them has an exactly-zero hat
    weight. Plain tensor ops (a zero pad and 108 strided slices), so
    autograd gives the adjoint; it adds no scatter."""
    z, y, x = sigma.shape
    sz, sy, sx = supercell_dims((z, y, x))
    pad = (0, 2 * sx + 1 - x, 0, 2 * sy + 1 - y, 0, 2 * sz + 1 - z)
    parts = []
    for ch in range(4):
        g = sigma if ch == 0 else color[..., ch - 1]
        g = torch.nn.functional.pad(g.to(torch.float32), pad)
        for vz in range(3):
            for vy in range(3):
                for vx in range(3):
                    parts.append(g[vz:vz + 2 * sz - 1:2, vy:vy + 2 * sy - 1:2,
                                   vx:vx + 2 * sx - 1:2])
    return torch.stack(parts, dim=-1).reshape(sz * sy * sx, SUPER_NCH)


def stack_plane_grads(t: torch.Tensor, sigma_shape) -> tuple:
    """(32, R) f32 stack cotangent -> (d_sigma (Z, Y, X), d_color
    (Z, Y, X, 3)): the adjoint of :func:`_shift_stack_fullpitch`'s offset
    slices, as 32 zero-padded shifted adds summed from 0 in corner order
    (``dvren_tpu/ops/grid.py::stack_plane_grads``)."""
    z, y, x = (int(v) for v in sigma_shape)
    p = z * y * x
    planes = []
    for ch in range(4):
        acc = t.new_zeros(p)
        for corner, off in enumerate(corner_offsets(sigma_shape)):
            col = t[ch * 8 + corner]
            acc = acc + torch.nn.functional.pad(col, (off, 0))[:p]
        planes.append(acc)
    d_sigma = planes[0].reshape(z, y, x)
    d_color = torch.stack([d.reshape(z, y, x) for d in planes[1:]], dim=-1)
    return d_sigma, d_color


# ------------------------------------------------------- point evaluation


def recording(t: torch.Tensor) -> bool:
    """Whether a CUDA graph is recording the stream that work on ``t``
    runs on: then the capture-safe forms run (:func:`accumulate_rows_fixed`),
    which read nothing to the host and give the same bits."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def accumulate_rows(dst: torch.Tensor, idx: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] += rows[i]`` in place, deterministically and without
    touching torch's global deterministic mode: a stable sort of the
    indices, each index's rows summed in that order
    (``torch.segment_reduce``, a fixed-order sum per segment and column),
    then one add per distinct index. While a CUDA graph records the
    stream, :func:`accumulate_rows_fixed` does it (the same bits): the
    distinct indices here are counted on the host."""
    if idx.numel() == 0:
        return dst
    if recording(dst):
        return accumulate_rows_fixed(dst, idx, rows)
    keys, order = torch.sort(idx, stable=True)
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    sums = torch.segment_reduce(rows[order], "sum", lengths=counts, axis=0)
    dst[uniq] += sums     # distinct indices: a plain indexed write
    return dst


def accumulate_rows_fixed(dst: torch.Tensor, idx: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """:func:`accumulate_rows` with every shape fixed by ``dst`` and
    ``idx`` and nothing read to the host, so that a CUDA graph can record
    it: each row of ``dst`` has a segment of the stably sorted indices
    (its bounds found by ``searchsorted``, length 0 for a row no index
    names), the segments are summed in that order (the same sums as the
    distinct indices' segments) and a row is added to only where its
    segment is not empty. No index is written twice."""
    if idx.numel() == 0:
        return dst
    keys, order = torch.sort(idx, stable=True)
    n_dst = int(dst.shape[0])
    bounds = torch.searchsorted(keys, torch.arange(
        n_dst + 1, dtype=keys.dtype, device=keys.device))
    lengths = bounds[1:] - bounds[:-1]
    sums = torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    hit = (lengths > 0).reshape((n_dst,) + (1,) * (dst.dim() - 1))
    dst.copy_(torch.where(hit, dst + sums, dst))
    return dst


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` for a (R, C) table and (S,) int64 indices; the
    backward sums the (S, C) cotangent into the table's rows in float32
    (:func:`accumulate_rows`) and rounds once to the table's dtype."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.meta = (tuple(table.shape), table.dtype)
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, dtype = ctx.meta
        d = torch.zeros(shape, dtype=torch.float32, device=g.device)
        accumulate_rows(d, idx, g.to(torch.float32))
        return d.to(dtype), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (any int shape, flattened) of a (R, C) table, as
    (S, C), with a deterministic backward."""
    return _TakeRows.apply(table, idx.reshape(-1).to(torch.int64))


def _axis_local(p: torch.Tensor, lo: float, hi: float):
    """World coordinate -> [0, 1] local along one axis, and the outside
    mask (grid_dense_cpu.cpp:99-105; a degenerate extent gives 0)."""
    extent = float(hi) - float(lo)
    if extent == 0.0:
        local = torch.zeros_like(p)
    else:
        local = (p - float(lo)) * (1.0 / extent)
    return local, (local < 0.0) | (local > 1.0)


def _locals(px, py, pz, bbox_min, bbox_max, oob):
    """(lx, ly, lz, outside or None) as ``dvren_tpu``'s evaluators take
    them: clamped into [0, 1] under OOB_CLAMP."""
    lx, ox = _axis_local(px, bbox_min[0], bbox_max[0])
    ly, oy = _axis_local(py, bbox_min[1], bbox_max[1])
    lz, oz = _axis_local(pz, bbox_min[2], bbox_max[2])
    if oob == OobPolicy.CLAMP:
        return (torch.clamp(lx, 0.0, 1.0), torch.clamp(ly, 0.0, 1.0),
                torch.clamp(lz, 0.0, 1.0), None)
    return lx, ly, lz, ox | oy | oz


def eval_grid_planes(grid: torch.Tensor, px, py, pz, bbox_min, bbox_max,
                     interp: InterpMode = InterpMode.LINEAR,
                     oob: OobPolicy = OobPolicy.ZERO):
    """A dense grid, (Z, Y, X) scalar or (Z, Y, X, C) vector, at world
    coordinate planes: one plane (scalar grid) or a tuple of C planes,
    float32, shaped like ``px``. Nearest rounds half away from zero
    (``floor(x + 0.5)``, C++ ``std::round``); trilinear takes the lerp
    chain of grid_dense_cpu.cpp:57-85. Differentiable in the grid and the
    coordinates."""
    scalar = grid.dim() == 3
    nz, ny, nx = (int(v) for v in grid.shape[:3])
    shape = px.shape
    lx, ly, lz, outside = _locals(px, py, pz, bbox_min, bbox_max, oob)
    fx = lx.reshape(-1) * (nx - 1)
    fy = ly.reshape(-1) * (ny - 1)
    fz = lz.reshape(-1) * (nz - 1)
    table = grid.reshape(nz * ny * nx, -1)

    def flat(iz, iy, ix):
        return (iz * ny + iy) * nx + ix

    if interp == InterpMode.NEAREST:
        ix = torch.clamp(torch.floor(fx + 0.5).long(), 0, nx - 1)
        iy = torch.clamp(torch.floor(fy + 0.5).long(), 0, ny - 1)
        iz = torch.clamp(torch.floor(fz + 0.5).long(), 0, nz - 1)
        vals = take_rows(table, flat(iz, iy, ix)).to(torch.float32)
    else:
        ix0 = torch.clamp(torch.floor(fx).long(), 0, nx - 1)
        iy0 = torch.clamp(torch.floor(fy).long(), 0, ny - 1)
        iz0 = torch.clamp(torch.floor(fz).long(), 0, nz - 1)
        ix1 = torch.clamp_max(ix0 + 1, nx - 1)
        iy1 = torch.clamp_max(iy0 + 1, ny - 1)
        iz1 = torch.clamp_max(iz0 + 1, nz - 1)
        tx = (fx - ix0.to(torch.float32))[:, None]
        ty = (fy - iy0.to(torch.float32))[:, None]
        tz = (fz - iz0.to(torch.float32))[:, None]
        idx = torch.stack([flat(iz0, iy0, ix0), flat(iz0, iy0, ix1),
                           flat(iz0, iy1, ix0), flat(iz0, iy1, ix1),
                           flat(iz1, iy0, ix0), flat(iz1, iy0, ix1),
                           flat(iz1, iy1, ix0), flat(iz1, iy1, ix1)])
        c = take_rows(table, idx).to(torch.float32).reshape(
            8, -1, table.shape[1])
        c00 = c[0] + (c[1] - c[0]) * tx
        c10 = c[2] + (c[3] - c[2]) * tx
        c01 = c[4] + (c[5] - c[4]) * tx
        c11 = c[6] + (c[7] - c[6]) * tx
        c0 = c00 + (c10 - c00) * ty
        c1 = c01 + (c11 - c01) * ty
        vals = c0 + (c1 - c0) * tz
    if outside is not None:
        vals = torch.where(outside.reshape(-1, 1), torch.zeros_like(vals),
                           vals)
    outs = [vals[:, i].reshape(shape) for i in range(vals.shape[1])]
    return outs[0] if scalar else tuple(outs)


def eval_grid(grid: torch.Tensor, positions: torch.Tensor, bbox_min,
              bbox_max, interp: InterpMode = InterpMode.LINEAR,
              oob: OobPolicy = OobPolicy.ZERO) -> torch.Tensor:
    """:func:`eval_grid_planes` at (..., 3) positions: (...,) for a scalar
    grid, (..., C) for a vector one."""
    out = eval_grid_planes(grid, positions[..., 0], positions[..., 1],
                           positions[..., 2], bbox_min, bbox_max, interp,
                           oob)
    if isinstance(out, tuple):
        return torch.stack(out, dim=-1)
    return out


def scatter_grid_grads(grid_shape, positions: torch.Tensor,
                       sample_grads: torch.Tensor, bbox_min, bbox_max,
                       interp: InterpMode = InterpMode.LINEAR,
                       oob: OobPolicy = OobPolicy.ZERO) -> torch.Tensor:
    """Per-sample gradients summed into a float32 grid of ``grid_shape``:
    the vjp of :func:`eval_grid` at a zero grid (``AccumulateSample
    Gradients``, dense_grid.cpp:171-309), so the interpolation weights are
    the forward's. The corner rows are summed by :func:`take_rows`'
    backward, in a fixed order."""
    zeros = torch.zeros(tuple(int(v) for v in grid_shape),
                        dtype=torch.float32, device=positions.device,
                        requires_grad=True)
    with torch.enable_grad():
        out = eval_grid(zeros, positions.detach(), bbox_min, bbox_max,
                        interp, oob)
        (grads,) = torch.autograd.grad(
            out, zeros, sample_grads.detach().to(torch.float32))
    return grads


def build_packed_stencil(sigma: torch.Tensor, color: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The trilinear stencil of every base cell, (Z-1, Y-1, X-1, 32) in
    ``dtype``: column corner*4 + ch, corner = dz*4 + dy*2 + dx, ch in
    (sigma, r, g, b), as ``dvren_tpu/ops/grid.py::build_packed_stencil``
    lays it out. Plain slices and a stack: autograd's adjoint adds no
    scatter."""
    z, y, x = (int(v) for v in sigma.shape)
    zm, ym, xm = z - 1, y - 1, x - 1
    parts = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                parts.append(sigma[dz:dz + zm, dy:dy + ym, dx:dx + xm])
                for ch in range(3):
                    parts.append(color[dz:dz + zm, dy:dy + ym, dx:dx + xm, ch])
    return torch.stack(parts, dim=-1).to(dtype)


def trilinear_fractions(grid_shape_zyx, px, py, pz, bbox_min, bbox_max,
                        oob: OobPolicy = OobPolicy.ZERO):
    """(base cell (ix, iy, iz), corner weights (S, 8) in corner order,
    zero outside the bbox under OOB_ZERO) of the packed evaluators; base
    cells run [0, n-2] per axis."""
    nz, ny, nx = (int(v) for v in grid_shape_zyx)
    lx, ly, lz, outside = _locals(px, py, pz, bbox_min, bbox_max, oob)
    fx = lx.reshape(-1) * (nx - 1)
    fy = ly.reshape(-1) * (ny - 1)
    fz = lz.reshape(-1) * (nz - 1)
    ix = torch.clamp(torch.floor(fx).long(), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).long(), 0, ny - 2)
    iz = torch.clamp(torch.floor(fz).long(), 0, nz - 2)
    tx = fx - ix.to(torch.float32)
    ty = fy - iy.to(torch.float32)
    tz = fz - iz.to(torch.float32)
    wx0, wx1 = 1.0 - tx, tx
    wy0, wy1 = 1.0 - ty, ty
    wz0, wz1 = 1.0 - tz, tz
    w = torch.stack([wz0 * wy0 * wx0, wz0 * wy0 * wx1, wz0 * wy1 * wx0,
                     wz0 * wy1 * wx1, wz1 * wy0 * wx0, wz1 * wy0 * wx1,
                     wz1 * wy1 * wx0, wz1 * wy1 * wx1], dim=-1)
    if outside is not None:
        w = w * (~outside).reshape(-1, 1).to(w.dtype)
    return (ix, iy, iz), w


def eval_packed_trilinear(packed: torch.Tensor, grid_shape_zyx, px, py, pz,
                          bbox_min, bbox_max,
                          oob: OobPolicy = OobPolicy.ZERO,
                          use_kernel: bool = True) -> tuple:
    """Trilinear (sigma, r, g, b) planes through one packed-stencil row
    per sample (``packed`` from :func:`build_packed_stencil`; a 16-bit
    table is gathered in its type, then widened). The same values as
    :func:`eval_grid_planes` under LINEAR, to rounding.

    Where :func:`~dvren_tpu_torch.ops.packed_eval.routes` holds (a CUDA
    table of float32, bfloat16 or float16) and ``use_kernel``, the
    kernels of ``csrc/packed_eval.cu`` evaluate it and take its adjoint
    into the table and the positions
    (:func:`~dvren_tpu_torch.ops.packed_eval.eval_planes`), counted in
    the counter ``dense.kernel_evals``; otherwise the code below, their
    plain twin, does."""
    if use_kernel and packed_eval.routes(packed):
        trace.count("dense.kernel_evals")
        return packed_eval.eval_planes(packed, grid_shape_zyx, px, py, pz,
                                       bbox_min, bbox_max, oob)
    nz, ny, nx = (int(v) for v in grid_shape_zyx)
    shape = px.shape
    (ix, iy, iz), w = trilinear_fractions(grid_shape_zyx, px, py, pz,
                                          bbox_min, bbox_max, oob)
    v = (iz * (ny - 1) + iy) * (nx - 1) + ix
    cube = take_rows(packed.reshape(-1, packed.shape[-1]), v).to(
        torch.float32)
    outs = torch.sum(w[:, :, None] * cube.reshape(-1, 8, 4), dim=1)
    return tuple(outs[:, c].reshape(shape) for c in range(4))
