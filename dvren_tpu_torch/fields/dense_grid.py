"""Dense voxel grid field: sigma (Z,Y,X) and color (Z,Y,X,3).

Counterpart of ``dvren_tpu/fields/dense_grid.py``. The field is an
``nn.Module`` whose two parameters are the grid values; its bbox, OOB
policy, interpolation mode and packed-table dtype are plain metadata.
Point evaluation and gradient scatter come with the general render paths
(ROADMAP Queue 1 item 11); the tiled renderer reads ``sigma`` and
``color`` whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch
from torch import nn

from dvren_tpu_torch.core.plan import InterpMode, OobPolicy
from dvren_tpu_torch.core.status import check


@dataclass(frozen=True)
class DenseGridConfig:
    """Mirrors ``dvren::DenseGridConfig``.

    resolution is (nx, ny, nz); sigma is flat [z][y][x] length nx*ny*nz;
    color is flat [z][y][x][c] length 3*nx*ny*nz.
    """

    resolution: tuple[int, int, int]
    sigma: np.ndarray | list[float] = dc_field(default_factory=list)
    color: np.ndarray | list[float] = dc_field(default_factory=list)
    bbox_min: tuple[float, float, float] = (0.0, 0.0, 0.0)
    bbox_max: tuple[float, float, float] = (1.0, 1.0, 1.0)
    interp: InterpMode = InterpMode.LINEAR
    oob: OobPolicy = OobPolicy.ZERO


class DenseGridField(nn.Module):
    """sigma: (Z, Y, X) float32 parameter; color: (Z, Y, X, 3) float32.

    ``packed_dtype`` names the element type of the packed-stencil table;
    the port builds float32 tables only (16-bit tables are ROADMAP Queue 1
    item 12)."""

    def __init__(self, sigma: torch.Tensor, color: torch.Tensor,
                 bbox_min=(0.0, 0.0, 0.0), bbox_max=(1.0, 1.0, 1.0),
                 interp: InterpMode = InterpMode.LINEAR,
                 oob: OobPolicy = OobPolicy.ZERO,
                 packed_dtype: str = "float32"):
        super().__init__()
        check(sigma.dim() == 3, "sigma must be (Z, Y, X)")
        check(tuple(color.shape) == tuple(sigma.shape) + (3,),
              "color must be (Z, Y, X, 3)")
        check(sigma.dtype == torch.float32 and color.dtype == torch.float32,
              "sigma and color must be float32")
        check(sigma.device == color.device,
              "sigma and color must be on one device")
        self.sigma = nn.Parameter(sigma)
        self.color = nn.Parameter(color)
        self.bbox_min = tuple(float(v) for v in bbox_min)
        self.bbox_max = tuple(float(v) for v in bbox_max)
        self.interp = InterpMode(interp)
        self.oob = OobPolicy(oob)
        self.packed_dtype = str(packed_dtype)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def create(config: DenseGridConfig, device=None) -> "DenseGridField":
        """Validates like ``DenseGridField::Create`` (dense_grid.cpp:69-130)."""
        nx, ny, nz = (int(v) for v in config.resolution)
        check(nx > 0 and ny > 0 and nz > 0, "resolution must be positive")
        voxels = nx * ny * nz
        sigma = np.asarray(config.sigma, dtype=np.float32).reshape(-1)
        color = np.asarray(config.color, dtype=np.float32).reshape(-1)
        check(sigma.size == voxels, "sigma data size mismatch")
        check(color.size == voxels * 3, "color data size mismatch")
        return DenseGridField(
            torch.from_numpy(sigma.reshape(nz, ny, nx).copy()).to(device),
            torch.from_numpy(color.reshape(nz, ny, nx, 3).copy()).to(device),
            bbox_min=config.bbox_min, bbox_max=config.bbox_max,
            interp=config.interp, oob=config.oob)

    @staticmethod
    def from_reference_arrays(sigma, color, bbox_min, bbox_max,
                              oob=OobPolicy.ZERO,
                              interp=InterpMode.LINEAR,
                              device=None) -> "DenseGridField":
        """A field from the JAX package's arrays, as numpy: ``sigma``
        (Z, Y, X) and ``color`` (Z, Y, X, 3) in that package's layout."""
        sigma = np.array(sigma, dtype=np.float32, copy=True)
        color = np.array(color, dtype=np.float32, copy=True)
        return DenseGridField(
            torch.from_numpy(sigma).to(device),
            torch.from_numpy(color).to(device),
            bbox_min=bbox_min, bbox_max=bbox_max, interp=interp, oob=oob)

    # -- shape facts ----------------------------------------------------------

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        """(Z, Y, X)."""
        return tuple(int(v) for v in self.sigma.shape)

    @property
    def resolution(self) -> tuple[int, int, int]:
        """(nx, ny, nz)."""
        nz, ny, nx = self.grid_shape
        return (nx, ny, nz)

    @property
    def voxel_count(self) -> int:
        return int(self.sigma.numel())
