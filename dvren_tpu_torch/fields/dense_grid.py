"""Dense voxel grid field: sigma (Z,Y,X) and color (Z,Y,X,3).

Counterpart of ``dvren_tpu/fields/dense_grid.py``. The field is an
``nn.Module`` whose two parameters are the grid values; its bbox, OOB
policy, interpolation mode and packed-table dtype are plain metadata.
The constructors put the grid on CUDA unless the caller names a device
(``device="cpu"`` on the CPU), as :class:`~dvren_tpu_torch.Context` does.
The tiled renderer reads ``sigma`` and ``color`` whole; the per-ray paths
evaluate the field at sample positions (``packed_eval_planes`` for a
trilinear grid, ``sigma_at_planes`` / ``color_at_planes`` otherwise), and
the Renderer's fused, staged and override backward sums per-sample
gradients into the grid with :meth:`accumulate_sample_gradients`.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch
from torch import nn

from dvren_tpu_torch.core.context import resolve_device
from dvren_tpu_torch.core.plan import InterpMode, OobPolicy
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops import grid as grid_ops
from dvren_tpu_torch.ops.grid import table_dtype
from dvren_tpu_torch.utils import trace


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

    ``packed_dtype`` names the element type of the packed-stencil table:
    "float32" (the default), "bfloat16" or "float16" (the 16-bit tables of
    the tiled renderer's flat-table route). Parameters passed in as
    ``nn.Parameter`` are kept, so :meth:`with_params` and
    :meth:`with_packed_dtype` can share them."""

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
        table_dtype(str(packed_dtype))      # raises on an unknown name
        self.sigma = (sigma if isinstance(sigma, nn.Parameter)
                      else nn.Parameter(sigma))
        self.color = (color if isinstance(color, nn.Parameter)
                      else nn.Parameter(color))
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
        device = resolve_device(device)
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
        device = resolve_device(device)
        return DenseGridField(
            torch.from_numpy(sigma).to(device),
            torch.from_numpy(color).to(device),
            bbox_min=bbox_min, bbox_max=bbox_max, interp=interp, oob=oob)

    # -- functional updates ---------------------------------------------------

    def with_params(self, sigma: torch.Tensor,
                    color: torch.Tensor) -> "DenseGridField":
        """The same metadata over new grid values."""
        return DenseGridField(sigma, color, bbox_min=self.bbox_min,
                              bbox_max=self.bbox_max, interp=self.interp,
                              oob=self.oob, packed_dtype=self.packed_dtype)

    def with_packed_dtype(self, dtype: str) -> "DenseGridField":
        """The same parameters with another packed-table dtype."""
        return DenseGridField(self.sigma, self.color, bbox_min=self.bbox_min,
                              bbox_max=self.bbox_max, interp=self.interp,
                              oob=self.oob, packed_dtype=dtype)

    # -- shape facts ----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.sigma.device

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

    # -- evaluation (the field protocol of the per-ray paths) -----------------

    def sigma_at(self, positions: torch.Tensor) -> torch.Tensor:
        """Density at (..., 3) world positions -> (...,); differentiable."""
        return grid_ops.eval_grid(self.sigma, positions, self.bbox_min,
                                  self.bbox_max, self.interp, self.oob)

    def color_at(self, positions: torch.Tensor) -> torch.Tensor:
        """Colour at (..., 3) world positions -> (..., 3); differentiable."""
        return grid_ops.eval_grid(self.color, positions, self.bbox_min,
                                  self.bbox_max, self.interp, self.oob)

    def sigma_at_planes(self, px, py, pz) -> torch.Tensor:
        """Density at coordinate planes; differentiable."""
        return grid_ops.eval_grid_planes(self.sigma, px, py, pz,
                                         self.bbox_min, self.bbox_max,
                                         self.interp, self.oob)

    def color_at_planes(self, px, py, pz) -> tuple:
        """(r, g, b) planes at coordinate planes; differentiable."""
        return grid_ops.eval_grid_planes(self.color, px, py, pz,
                                         self.bbox_min, self.bbox_max,
                                         self.interp, self.oob)

    @property
    def supports_packed_eval(self) -> bool:
        """The packed-stencil route needs trilinear and all dims >= 2."""
        return (self.interp == InterpMode.LINEAR
                and min(self.grid_shape) >= 2)

    def packed_eval_planes(self, px, py, pz) -> tuple:
        """(sigma, r, g, b) planes through one packed-stencil row per
        sample, the stencil built in ``packed_dtype`` from the current
        parameters (autograd reaches sigma and color through it). Its
        stages (``utils/trace.py``): ``stencil``, then ``eval`` (the row
        reads); in the backward, ``stencil_grad`` (the stencil's adjoint
        into sigma and colour). On the card the evaluation and its adjoint
        into the stencil rows and the positions are the kernels of
        ``csrc/packed_eval.cu`` (``ops/packed_eval.py``); the counter
        ``dense.kernel_evals`` counts each evaluation they take, a
        recomputed one again, and stays 0 on the CPU."""
        trace.stage("stencil")
        (packed,) = trace.stage_on_backward(
            "stencil_grad", grid_ops.build_packed_stencil(
                self.sigma, self.color, table_dtype(self.packed_dtype)))
        trace.stage("eval")
        return grid_ops.eval_packed_trilinear(
            packed, self.grid_shape, px, py, pz, self.bbox_min,
            self.bbox_max, self.oob)

    # -- gradients ------------------------------------------------------------

    def zero_grads(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(sigma_grad, color_grad) zeroed; DenseGridField::ZeroGradients."""
        return (torch.zeros_like(self.sigma, requires_grad=False),
                torch.zeros_like(self.color, requires_grad=False))

    def accumulate_sample_gradients(self, positions: torch.Tensor,
                                    grad_sigma: torch.Tensor,
                                    grad_color: torch.Tensor,
                                    grads: tuple | None = None) -> tuple:
        """Per-sample gradients summed into voxel gradients
        (``AccumulateSampleGradients``, dense_grid.cpp:171-309): the vjp
        of the field's point evaluation at (..., 3) ``positions``, with
        ``grad_sigma`` (...,) and ``grad_color`` (..., 3); added to
        ``grads`` when given. No float atomics: the corner rows are
        summed in a fixed order (:func:`~dvren_tpu_torch.ops.grid.
        scatter_grid_grads`)."""
        sigma_g = grid_ops.scatter_grid_grads(
            self.sigma.shape, positions, grad_sigma, self.bbox_min,
            self.bbox_max, self.interp, self.oob)
        color_g = grid_ops.scatter_grid_grads(
            self.color.shape, positions, grad_color, self.bbox_min,
            self.bbox_max, self.interp, self.oob)
        if grads is not None:
            sigma_g = grads[0] + sigma_g
            color_g = grads[1] + color_g
        return sigma_g, color_g
