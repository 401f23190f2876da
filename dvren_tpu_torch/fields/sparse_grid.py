"""Sparse brick-grid field: the packed stencil rows of occupied bricks.

Counterpart of ``dvren_tpu/fields/sparse_grid.py``. The (Z-1, Y-1, X-1)
base cells of a dense grid are grouped into bricks of ``BRICK``^3 cells;
an int32 occupancy table (Bz, By, Bx) maps each brick to its slot in
``bricks`` (n_bricks, BRICK^3, 32), slot 0 being the shared all-zero
brick. Each brick row holds its cell's full trilinear stencil in the
channel-major layout of the dense packed table (column ch*8 + corner,
ch in sigma, r, g, b), so the tiled renderer gathers brick rows exactly
as it gathers dense table rows: its schedule resolves cells to brick rows
on the host (:func:`dvren_tpu_torch.render.tiled.build_tiled_schedule`).

The field is an ``nn.Module``: ``bricks`` (float32, bfloat16 or float16)
is its parameter, the occupancy a buffer (topology: static). The
constructors put both on CUDA unless the caller names a device.
Point evaluation (``packed_eval_planes``) comes with the streamed
pipeline (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dvren_tpu_torch.core.context import resolve_device
from dvren_tpu_torch.core.plan import InterpMode, OobPolicy
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops.grid import NCH, TABLE_DTYPES, table_dtype

BRICK = 8
_SIGMA_CH = tuple(range(8))    # the sigma columns of a packed row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def occupancy_shape(grid_shape) -> tuple[int, int, int]:
    """(Bz, By, Bx): bricks covering the (Z-1, Y-1, X-1) base cells."""
    return tuple(_cdiv(int(n) - 1, BRICK) for n in grid_shape)


def build_bricks(sigma: np.ndarray, color: np.ndarray,
                 threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """(bricks (n_bricks, BRICK^3, 32) f32, occupancy (Bz, By, Bx) int32)
    of a dense grid, streamed over z-slabs of bricks, as
    ``dvren_tpu``'s ``SparseGridField.from_dense`` builds them: a brick is
    kept iff one of its sigma stencil values exceeds ``threshold`` in
    magnitude; kept bricks take slots 1, 2, ... in (z, y, x) order."""
    nz, ny, nx = sigma.shape
    zm, ym, xm = nz - 1, ny - 1, nx - 1
    bz, by, bx = occupancy_shape(sigma.shape)
    occupancy = np.zeros((bz, by, bx), np.int32)
    brick_rows = [np.zeros((BRICK ** 3, NCH), np.float32)]   # slot 0
    pad_y, pad_x = by * BRICK, bx * BRICK
    for bz_i in range(bz):
        z0 = bz_i * BRICK
        z_hi = min(z0 + BRICK, zm)
        slab_sigma = sigma[z0:z_hi + 1]
        slab_color = color[z0:z_hi + 1]
        zc = z_hi - z0
        parts = [[], [], [], []]
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    parts[0].append(slab_sigma[dz:dz + zc, dy:dy + ym,
                                               dx:dx + xm, None])
                    for ch in range(3):
                        parts[ch + 1].append(
                            slab_color[dz:dz + zc, dy:dy + ym, dx:dx + xm,
                                       ch:ch + 1])
        packed = np.concatenate(parts[0] + parts[1] + parts[2] + parts[3],
                                axis=-1)                   # (zc, ym, xm, 32)
        packed = np.pad(packed, ((0, BRICK - zc), (0, pad_y - ym),
                                 (0, pad_x - xm), (0, 0)))
        tiles = packed.reshape(BRICK, by, BRICK, bx, BRICK, NCH)
        tiles = tiles.transpose(1, 3, 0, 2, 4, 5).reshape(
            by, bx, BRICK ** 3, NCH)
        sig_max = np.abs(tiles[..., list(_SIGMA_CH)]).max(axis=(2, 3))
        occ_y, occ_x = np.nonzero(sig_max > threshold)
        for j, (by_i, bx_i) in enumerate(zip(occ_y, occ_x)):
            occupancy[bz_i, by_i, bx_i] = len(brick_rows) + j
        if occ_y.size:
            brick_rows.extend(tiles[occ_y, occ_x].astype(np.float32))
    return np.stack(brick_rows), occupancy


class SparseGridField(nn.Module):
    """bricks: (n_bricks, BRICK^3, 32) parameter; occupancy: (Bz, By, Bx)
    int32 buffer; ``grid_shape`` is the dense source's (Z, Y, X)."""

    def __init__(self, bricks: torch.Tensor, occupancy: torch.Tensor,
                 grid_shape, bbox_min=(0.0, 0.0, 0.0),
                 bbox_max=(1.0, 1.0, 1.0), oob: OobPolicy = OobPolicy.ZERO):
        super().__init__()
        grid_shape = tuple(int(v) for v in grid_shape)
        check(len(grid_shape) == 3 and min(grid_shape) >= 2,
              "sparse bricks require a (Z, Y, X) grid with dims >= 2")
        check(bricks.dim() == 3
              and tuple(bricks.shape[1:]) == (BRICK ** 3, NCH)
              and bricks.shape[0] >= 1,
              f"bricks must be (n_bricks, {BRICK ** 3}, {NCH})")
        check(bricks.dtype in TABLE_DTYPES.values(),
              "bricks must be float32, bfloat16 or float16")
        check(occupancy.dtype == torch.int32
              and tuple(occupancy.shape) == occupancy_shape(grid_shape),
              f"occupancy must be int32 {occupancy_shape(grid_shape)}")
        check(bricks.device == occupancy.device,
              "bricks and occupancy must be on one device")
        self.bricks = (bricks if isinstance(bricks, nn.Parameter)
                       else nn.Parameter(bricks))
        self.register_buffer("occupancy", occupancy)
        self.grid_shape = grid_shape
        self.bbox_min = tuple(float(v) for v in bbox_min)
        self.bbox_max = tuple(float(v) for v in bbox_max)
        self.oob = OobPolicy(oob)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_dense(field, threshold: float = 0.0, dtype: str = "float32",
                   device=None) -> "SparseGridField":
        """From a :class:`~dvren_tpu_torch.DenseGridField` (LINEAR
        interpolation), built in numpy on the host. With threshold 0 the
        render equals the dense one (dropped bricks have zero density, so
        their colour cannot contribute)."""
        check(field.interp == InterpMode.LINEAR,
              "sparse bricks require trilinear interpolation")
        sigma = field.sigma.detach().cpu().numpy()
        color = field.color.detach().cpu().numpy()
        check(min(sigma.shape) >= 2, "sparse bricks require dims >= 2")
        bricks, occupancy = build_bricks(sigma, color, threshold)
        device = resolve_device(device)
        return SparseGridField(
            torch.from_numpy(bricks).to(table_dtype(str(dtype))).to(device),
            torch.from_numpy(occupancy).to(device), sigma.shape,
            bbox_min=field.bbox_min, bbox_max=field.bbox_max, oob=field.oob)

    @staticmethod
    def from_reference(bricks, occupancy, grid_shape, bbox_min, bbox_max,
                       oob=OobPolicy.ZERO, device=None) -> "SparseGridField":
        """A field from the JAX field's arrays carried across as numpy
        (``np.asarray`` of each); the bricks keep their element type
        (float32, bfloat16 or float16)."""
        b = np.asarray(bricks)
        dtype = table_dtype(str(b.dtype))
        device = resolve_device(device)
        return SparseGridField(
            torch.from_numpy(np.array(b, np.float32)).to(dtype).to(device),
            torch.from_numpy(np.array(occupancy, np.int32)).to(device),
            grid_shape, bbox_min=bbox_min, bbox_max=bbox_max, oob=oob)

    def with_params(self, bricks: torch.Tensor) -> "SparseGridField":
        """The same topology (occupancy, shape, bbox) over a new brick
        table; an ``nn.Parameter`` is shared."""
        return SparseGridField(bricks, self.occupancy, self.grid_shape,
                               bbox_min=self.bbox_min,
                               bbox_max=self.bbox_max, oob=self.oob)

    # -- facts ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.bricks.device

    @property
    def occupied_bricks(self) -> int:
        return int(self.bricks.shape[0]) - 1

    @property
    def total_bricks(self) -> int:
        return int(self.occupancy.numel())

    def memory_bytes(self) -> int:
        return int(self.bricks.numel() * self.bricks.element_size()
                   + self.occupancy.numel() * 4)
