"""Full-pitch packed trilinear stencil: row count and plain shift stack.

Counterpart of ``fullpitch_rows`` and ``_shift_stack_fullpitch`` in
``dvren_tpu/ops/grid.py``. The packed table has one row per grid cell v =
(iz*Y + iy)*X + ix (full grid pitch) and 32 columns ``ch*8 + corner``
with ``corner = dz*4 + dy*2 + dx`` over the channels (sigma, r, g, b).
At full pitch every column is the flattened channel plane shifted by the
pure offset ``dz*Y*X + dy*X + dx``, zero past the end. Rows of cells on
the far faces (ix == X-1 and so on) read wrapped neighbours and are never
named by a schedule.

The table itself is built by the CUDA kernel in
:mod:`dvren_tpu_torch.ops.packed_transpose`; the stack here is the plain
half of that kernel's twin.
"""

from __future__ import annotations

import torch

NCH = 32     # packed columns: 4 channels x 8 corners


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
