"""The packed-stencil point evaluation on the card (``csrc/packed_eval.cu``).

:func:`eval_planes` is the (sigma, r, g, b) evaluation of a packed
trilinear stencil at sample positions as one autograd node: its forward
is one launch of ``packed_eval_forward_kernel`` (a thread a sample, the
cell's 128-byte row read once, nothing per sample kept but the four
planes), its backward the stencil rows' cotangents in float32, rounded
once to the table's type, by a gather-only segment sum: cell keys, a
stable radix sort of (key, index) pairs over the key's bits, segment
bounds from adjacent keys, a warp a row (``packed_eval_backward``); where
the positions carry a gradient (a camera differentiated through them),
the keys' launch also writes their cotangent. No float atomics; repeat
backwards give the same bits.

Its plain twin is ``ops/grid.py::eval_packed_trilinear`` with
``use_kernel=False`` (what every CPU table runs): the kernels compute the
twin's corner weights bit for bit and its sums in a fixed order. A 16-bit
table's cotangent differs from the twin's by design: the twin (and the
JAX package) rounds each sample's row to the table's type before it sums,
the kernels sum in float32 and round once. :func:`routes` says which
evaluations the kernels take: a CUDA table of float32, bfloat16 or
float16.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from dvren_tpu_torch import _build
from dvren_tpu_torch.core.plan import OobPolicy
from dvren_tpu_torch.core.status import check

NCH = 32                      # packed columns: 8 corners x 4 channels
TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def routes(table: torch.Tensor) -> bool:
    """Whether :func:`eval_planes` takes an evaluation of ``table``: a
    CUDA table of a type in :data:`TABLE_TYPES`."""
    return table.is_cuda and table.dtype in TABLE_TYPES


def geometry(grid_shape_zyx, bbox_min, bbox_max, oob) -> tuple:
    """The kernels' constants, as the twin's tensor ops round them: (nx,
    ny, nz, lo x3, inv x3, degenerate axes as bits, clamp). ``lo`` is
    bbox_min as float32, ``inv`` 1 / extent taken in double and rounded
    to float32 (``ops/grid.py::_axis_local``); a zero extent sets the
    axis's bit (its local is 0)."""
    nz, ny, nx = (int(v) for v in grid_shape_zyx)
    lo, inv, degenerate = [], [], 0
    for a in range(3):
        extent = float(bbox_max[a]) - float(bbox_min[a])
        lo.append(float(np.float32(bbox_min[a])))
        if extent == 0.0:
            degenerate |= 1 << a
            inv.append(0.0)
        else:
            inv.append(float(np.float32(1.0 / extent)))
    clamp = int(OobPolicy(oob) == OobPolicy.CLAMP)
    return (nx, ny, nz, *lo, *inv, degenerate, clamp)


def _rows(geom) -> int:
    nx, ny, nz = geom[:3]
    return (nz - 1) * (ny - 1) * (nx - 1)


def _rows_of(table: torch.Tensor, geom) -> torch.Tensor:
    """``table`` as (R, 32) rows the kernels read as 16-byte words."""
    table = table.reshape(-1, NCH).contiguous()
    check(table.data_ptr() % 16 == 0,
          "packed_eval: the kernel reads rows as 16-byte words; the table "
          "must start on a 16-byte boundary")
    check(table.shape[0] == _rows(geom),
          f"packed_eval: the table has {table.shape[0]} rows, the grid "
          f"{_rows(geom)}")
    return table


def _flat_positions(dev, px, py, pz) -> tuple:
    flat = []
    for name, p in (("px", px), ("py", py), ("pz", pz)):
        check(p.dtype == torch.float32 and p.device == dev
              and p.shape == px.shape,
              f"packed_eval: {name} must be float32 on {dev}, shaped like px")
        flat.append(p.reshape(-1).contiguous())
    check(flat[0].numel() < 2 ** 31,
          "packed_eval: the sort's indices are 32-bit: fewer than 2^31 "
          "samples a call")
    return tuple(flat)


def packed_eval_forward(table: torch.Tensor, px, py, pz, geom) -> tuple:
    """The (sigma, r, g, b) planes, shaped like ``px``, of the (R, 32)
    ``table`` at the positions. One launch; CUDA tensors only."""
    dev = table.device
    check(dev.type == "cuda", f"packed_eval runs on the card, got {dev}")
    check(table.dtype in TABLE_TYPES,
          f"packed_eval: table type {table.dtype} is not one of "
          f"{list(TABLE_TYPES)}")
    table = _rows_of(table, geom)
    flat = _flat_positions(dev, px, py, pz)
    n = flat[0].numel()
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(4)]
    with torch.cuda.device(dev):
        code = _build.library().dvt_packed_eval_forward(
            *(p.data_ptr() for p in flat), table.data_ptr(),
            TABLE_TYPES[table.dtype], *(o.data_ptr() for o in outs), n,
            *geom, _build.stream_ptr(dev))
    _build.check(code, "dvt_packed_eval_forward")
    packed_eval_forward.launches += 1
    return tuple(o.reshape(px.shape) for o in outs)


packed_eval_forward.launches = 0


@functools.lru_cache(maxsize=64)
def _sort_bytes(n: int, end_bit: int, device: int) -> int:
    out = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        code = _build.library().dvt_packed_eval_sort_bytes(
            n, end_bit, ctypes.addressof(out))
    _build.check(code, "dvt_packed_eval_sort_bytes")
    return int(out.value)


def sort_bits(n_rows: int) -> int:
    """The key bits the backward sorts on: keys run 0..n_rows, n_rows
    being the sentinel of samples outside the bbox (18 bits at 63^3)."""
    return int(n_rows).bit_length()


def packed_eval_backward(px, py, pz, grads, table: torch.Tensor, geom,
                         table_grad: bool = True,
                         position_grad: bool = False) -> tuple:
    """The cotangents of the four plane cotangents ``grads`` (each shaped
    like ``px``) of an evaluation of ``table``: with ``table_grad`` the
    (R, 32) table cotangent in its type (rounded once from float32 sums),
    with ``position_grad`` those of px, py and pz (None where not asked
    for). The keys, the sort, the bounds and the segment sums on one
    stream, their scratch allocated here; CUDA tensors only."""
    dev = px.device
    check(dev.type == "cuda", f"packed_eval runs on the card, got {dev}")
    dtype = table.dtype
    check(dtype in TABLE_TYPES, f"packed_eval: table type {dtype}")
    table = _rows_of(table, geom)
    flat = _flat_positions(dev, px, py, pz)
    gflat = []
    for g in grads:
        check(g.dtype == torch.float32 and g.device == dev
              and g.shape == px.shape,
              "packed_eval: the plane cotangents must be float32, shaped "
              "like px")
        gflat.append(g.reshape(-1).contiguous())
    n, rows = flat[0].numel(), _rows(geom)
    end_bit = sort_bits(rows)
    pairs = torch.empty((4, n), dtype=torch.int32, device=dev)
    records = torch.empty((n, 8), dtype=torch.float32, device=dev)
    temp = torch.empty(_sort_bytes(n, end_bit, dev.index or 0)
                       if table_grad else 0, dtype=torch.uint8, device=dev)
    seg = torch.empty((rows if table_grad else 0, 2), dtype=torch.int32,
                      device=dev)
    out = (torch.empty((rows, NCH), dtype=dtype, device=dev)
           if table_grad else None)
    dp = (torch.empty((3, n), dtype=torch.float32, device=dev)
          if position_grad else None)
    with torch.cuda.device(dev):
        code = _build.library().dvt_packed_eval_backward(
            *(p.data_ptr() for p in flat), *(g.data_ptr() for g in gflat),
            table.data_ptr(), *(pairs[i].data_ptr() for i in range(4)),
            records.data_ptr(), temp.data_ptr(), temp.numel(),
            seg.data_ptr(), None if out is None else out.data_ptr(),
            *((None,) * 3 if dp is None
              else (dp[a].data_ptr() for a in range(3))),
            TABLE_TYPES[dtype], n, rows, end_bit, *geom,
            _build.stream_ptr(dev))
    _build.check(code, "dvt_packed_eval_backward")
    packed_eval_backward.launches += 1
    dps = ((None,) * 3 if dp is None
           else tuple(dp[a].reshape(px.shape) for a in range(3)))
    return (out,) + dps


packed_eval_backward.launches = 0


class _PackedEval(torch.autograd.Function):
    """(table (R, 32), px, py, pz) -> the four planes; the backward gives
    the cotangents autograd asks for, of the table and of the
    positions."""

    @staticmethod
    def forward(ctx, table, px, py, pz, geom):
        ctx.save_for_backward(table, px, py, pz)
        ctx.geom = geom
        return packed_eval_forward(table, px, py, pz, geom)

    @staticmethod
    @once_differentiable
    def backward(ctx, gs, gr, gg, gb):
        table, px, py, pz = ctx.saved_tensors
        need = ctx.needs_input_grad
        d, dpx, dpy, dpz = packed_eval_backward(
            px, py, pz, (gs, gr, gg, gb), table, ctx.geom,
            table_grad=need[0], position_grad=any(need[1:4]))
        return (None if d is None else d.reshape(table.shape),
                dpx if need[1] else None, dpy if need[2] else None,
                dpz if need[3] else None, None)


def eval_planes(packed: torch.Tensor, grid_shape_zyx, px, py, pz, bbox_min,
                bbox_max, oob: OobPolicy = OobPolicy.ZERO) -> tuple:
    """Trilinear (sigma, r, g, b) planes, shaped like ``px``, through the
    packed stencil ``packed`` ((Z-1, Y-1, X-1, 32) or (R, 32)) on the
    card, differentiable in ``packed``."""
    geom = geometry(grid_shape_zyx, bbox_min, bbox_max, oob)
    return _PackedEval.apply(packed, px, py, pz, geom)
