"""The packed-stencil table (K3, K5a) and its gradient's unpack (K4, K5b).

Counterpart of ``dvren_tpu/ops/packed_transpose.py::stack_to_u16_rows``
as the tiled path reaches it (``dvren_tpu/ops/grid.py::build_packed_table16``:
the XLA shift stack, then the Pallas transpose-and-split). The CUDA
kernel ``csrc/packed_table.cu`` fuses both steps and writes the float32
table; the TPU's u16 hi/lo split served its gathers only, and the f32
rows here equal ``hi << 16 | lo`` of its rows bit for bit.

:func:`build_rows` takes the kernel for CUDA tensors and the plain twin
:func:`build_rows_plain` for CPU tensors; it never moves data between
devices. ``build_rows.launches`` counts kernel launches.

K4, :func:`table_grad_to_params`, is the backward's counterpart of
``dvren_tpu/ops/packed_transpose.py::u16_rows_to_stack`` followed by
``grid.stack_plane_grads``: (R, 32) f32 table gradient -> (d_sigma,
d_color), fused in ``csrc/packed_table_bwd.cu`` as a gather with no
atomics; its twin :func:`table_grad_to_params_plain` transposes and runs
the 32 shifted adds, and the two agree bit for bit.

K5a, :func:`build_rows16`, builds the table in bfloat16 or float16: the
counterpart of ``dvren_tpu/ops/packed_transpose.py::stack_to_rows`` on
the route ``dvren_tpu/ops/grid.py::_build_fullpitch`` takes for a 16-bit
``packed_dtype`` (shift stack, cast, transpose), fused in
``csrc/packed_table16.cu``. K5b, :func:`table16_grad_to_params`, is its
adjoint (``rows_to_stack`` on the f32-cast cotangent, then
``stack_plane_grads``), K4's gather with a 16-bit input in
``csrc/packed_table16_bwd.cu``. Both are bit-equal to their twins.
"""

from __future__ import annotations

import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.ops.grid import (NCH, _shift_stack_fullpitch,
                                     fullpitch_rows, stack_plane_grads)


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


def table_grad_to_params_plain(table_grad: torch.Tensor, grid_shape) -> tuple:
    """Plain twin of K4: the shifted adds of the transposed gradient."""
    return stack_plane_grads(table_grad.T, grid_shape)


def table_grad_to_params(table_grad: torch.Tensor, grid_shape) -> tuple:
    """(R, 32) f32 packed-table gradient -> (d_sigma (Z, Y, X), d_color
    (Z, Y, X, 3)) for a grid of shape ``grid_shape`` (Z, Y, X)."""
    z, y, x = (int(v) for v in grid_shape)
    want = (fullpitch_rows((z, y, x)), NCH)
    if tuple(table_grad.shape) != want:
        raise ValueError(f"table_grad: want shape {want}, got "
                         f"{tuple(table_grad.shape)}")
    if table_grad.dtype != torch.float32:
        raise TypeError(f"table_grad: want torch.float32, got "
                        f"{table_grad.dtype}")
    if table_grad.device.type == "cpu":
        return table_grad_to_params_plain(table_grad, (z, y, x))
    if table_grad.device.type != "cuda":
        raise ValueError(f"unsupported device {table_grad.device}")
    if not table_grad.is_contiguous():
        raise ValueError("table_grad must be contiguous")
    dev = table_grad.device
    d_sigma = torch.empty((z, y, x), dtype=torch.float32, device=dev)
    d_color = torch.empty((z, y, x, 3), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_packed_table_grad(
            table_grad.data_ptr(), d_sigma.data_ptr(), d_color.data_ptr(),
            z, y, x, _build.stream_ptr(dev))
    _build.check(code, "dvt_packed_table_grad")
    table_grad_to_params.launches += 1
    return d_sigma, d_color


table_grad_to_params.launches = 0


# 16-bit tables (K5a / K5b): the kernels' type codes
_KIND16 = {torch.bfloat16: 0, torch.float16: 1}


def _check_dtype16(dtype, what: str) -> int:
    if dtype not in _KIND16:
        raise TypeError(f"{what}: want torch.bfloat16 or torch.float16, got "
                        f"{dtype}")
    return _KIND16[dtype]


def build_rows16_plain(sigma: torch.Tensor, color: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Plain twin of K5a: the shift stack, cast to ``dtype`` (round to
    nearest even), transposed."""
    n_rows = fullpitch_rows(sigma.shape)
    stack = _shift_stack_fullpitch(sigma, color, n_rows)
    return stack.to(dtype).T.contiguous()


def build_rows16(sigma: torch.Tensor, color: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """(fullpitch_rows, 32) packed table of a dense grid in ``dtype``
    (torch.bfloat16 or torch.float16)."""
    _check_inputs(sigma, color)
    kind = _check_dtype16(dtype, "dtype")
    if sigma.device.type == "cpu":
        return build_rows16_plain(sigma, color, dtype)
    if sigma.device.type != "cuda":
        raise ValueError(f"unsupported device {sigma.device}")
    if not (sigma.is_contiguous() and color.is_contiguous()):
        raise ValueError("sigma and color must be contiguous")
    z, y, x = (int(v) for v in sigma.shape)
    n_rows = fullpitch_rows(sigma.shape)
    out = torch.empty((n_rows, NCH), dtype=dtype, device=sigma.device)
    lib = _build.library()
    with torch.cuda.device(sigma.device):
        code = lib.dvt_packed_table16(
            sigma.data_ptr(), color.data_ptr(), out.data_ptr(),
            z, y, x, n_rows, kind, _build.stream_ptr(sigma.device))
    _build.check(code, "dvt_packed_table16")
    build_rows16.launches += 1
    return out


build_rows16.launches = 0


def table16_grad_to_params_plain(table_grad16: torch.Tensor,
                                 grid_shape) -> tuple:
    """Plain twin of K5b: widen to float32, transpose, the 32 shifted
    adds."""
    return stack_plane_grads(table_grad16.float().T, grid_shape)


def table16_grad_to_params(table_grad16: torch.Tensor, grid_shape) -> tuple:
    """(R, 32) bfloat16 or float16 packed-table gradient -> float32
    (d_sigma (Z, Y, X), d_color (Z, Y, X, 3)) for a grid of shape
    ``grid_shape`` (Z, Y, X)."""
    z, y, x = (int(v) for v in grid_shape)
    want = (fullpitch_rows((z, y, x)), NCH)
    if tuple(table_grad16.shape) != want:
        raise ValueError(f"table_grad16: want shape {want}, got "
                         f"{tuple(table_grad16.shape)}")
    kind = _check_dtype16(table_grad16.dtype, "table_grad16")
    if table_grad16.device.type == "cpu":
        return table16_grad_to_params_plain(table_grad16, (z, y, x))
    if table_grad16.device.type != "cuda":
        raise ValueError(f"unsupported device {table_grad16.device}")
    if not table_grad16.is_contiguous():
        raise ValueError("table_grad16 must be contiguous")
    dev = table_grad16.device
    d_sigma = torch.empty((z, y, x), dtype=torch.float32, device=dev)
    d_color = torch.empty((z, y, x, 3), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_packed_table16_grad(
            table_grad16.data_ptr(), d_sigma.data_ptr(), d_color.data_ptr(),
            z, y, x, kind, _build.stream_ptr(dev))
    _build.check(code, "dvt_packed_table16_grad")
    table16_grad_to_params.launches += 1
    return d_sigma, d_color


table16_grad_to_params.launches = 0
