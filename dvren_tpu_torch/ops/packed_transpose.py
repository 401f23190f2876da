"""The packed-stencil table build (K3): grid -> (R, 32) float32 rows.

Counterpart of ``dvren_tpu/ops/packed_transpose.py::stack_to_u16_rows``
as the tiled path reaches it (``dvren_tpu/ops/grid.py::build_packed_table16``:
the XLA shift stack, then the Pallas transpose-and-split). The CUDA
kernel ``csrc/packed_table.cu`` fuses both steps and writes the float32
table; the TPU's u16 hi/lo split served its gathers only, and the f32
rows here equal ``hi << 16 | lo`` of its rows bit for bit.

:func:`build_rows` takes the kernel for CUDA tensors and the plain twin
:func:`build_rows_plain` for CPU tensors; it never moves data between
devices. ``build_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.ops.grid import NCH, _shift_stack_fullpitch, fullpitch_rows


def build_rows_plain(sigma: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: the shift stack, transposed."""
    n_rows = fullpitch_rows(sigma.shape)
    return _shift_stack_fullpitch(sigma, color, n_rows).T.contiguous()


def _check_inputs(sigma: torch.Tensor, color: torch.Tensor) -> None:
    if sigma.dim() != 3 or tuple(color.shape) != tuple(sigma.shape) + (3,):
        raise ValueError(
            f"want sigma (Z,Y,X) and color (Z,Y,X,3), got "
            f"{tuple(sigma.shape)} and {tuple(color.shape)}")
    if sigma.dtype != torch.float32 or color.dtype != torch.float32:
        raise TypeError(f"want float32, got {sigma.dtype} / {color.dtype}")
    if sigma.device != color.device:
        raise ValueError(f"sigma on {sigma.device}, color on {color.device}")


def build_rows(sigma: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """(fullpitch_rows, 32) float32 packed table of a dense grid."""
    _check_inputs(sigma, color)
    if sigma.device.type == "cpu":
        return build_rows_plain(sigma, color)
    if sigma.device.type != "cuda":
        raise ValueError(f"unsupported device {sigma.device}")
    if not (sigma.is_contiguous() and color.is_contiguous()):
        raise ValueError("sigma and color must be contiguous")
    z, y, x = (int(v) for v in sigma.shape)
    n_rows = fullpitch_rows(sigma.shape)
    out = torch.empty((n_rows, NCH), dtype=torch.float32,
                      device=sigma.device)
    lib = _build.library()
    with torch.cuda.device(sigma.device):
        code = lib.dvt_packed_table(
            sigma.data_ptr(), color.data_ptr(), out.data_ptr(),
            z, y, x, n_rows, _build.stream_ptr(sigma.device))
    _build.check(code, "dvt_packed_table")
    build_rows.launches += 1
    return out


build_rows.launches = 0
