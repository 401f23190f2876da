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
"""

from __future__ import annotations

import torch

from dvren_tpu_torch.core.status import DvrenError

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
