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
``csrc/packed_table.cu`` beside K3, whose staged source spans it shares
(staged as 16-bit pair words). K5b, :func:`table16_grad_to_params`, is
its adjoint (``rows_to_stack`` on the f32-cast cotangent, then
``stack_plane_grads``): K4's kernel in ``csrc/packed_table_bwd.cu`` with
a 16-bit row. Both are bit-equal to their twins.

K6, :func:`banks_to_rows`, is the split tiled backward's relayout, the
counterpart of ``dvren_tpu/ops/packed_transpose.py::banks_to_u16_rows``:
K2's bank-block cotangents (B, 32, 128) f32 -> slot rows (B*128, 32) f32
(``csrc/banks_to_rows.cu``, a shared-memory transpose that moves 32-bit
words). Its rows equal ``hi << 16 | lo`` of JAX's u16 rows, and its twin
:func:`banks_to_rows_plain`, bit for bit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from dvren_tpu_torch import _build
from dvren_tpu_torch.ops.grid import (NCH, _shift_stack_fullpitch,
                                     fullpitch_rows, stack_plane_grads)

# K3 / K5a and K4 / K5b launch geometry, kept per grid shape. The wrappers
# pass it to the kernels as it is, and tests/test_torch_packed_tiling.py
# rebuilds the tables and their gradients block by block from it on the
# CPU.
N_SMS = 132                  # the H100's SMs: 2 blocks each, at least
SMEM_LIMIT = 232_448         # shared memory a block may take on the H100
TABLE_ROWS = 256             # K3: table rows a block writes (a thread each)


@dataclass(frozen=True)
class TableTiling:
    """K3's and K5a's launch. Block b writes table rows [b * rows, (b + 1)
    * rows) (those below ``n_rows``), one thread a row. It first stages,
    for each (dz, dy), the ``rows + 1`` voxels of every channel that start
    at :meth:`span_start` (zero from ``n_cells`` on) in shared memory:
    plane ``dy * 8 + ch * 2 + dz`` of ``stride`` 32-bit words. K3 stages
    floats, so that the row's 16-byte word q = ch * 2 + dz is planes q and
    8 + q at the row's voxel and the next one. K5a stages pair words, word
    i holding voxels i and i + 1 rounded to 16 bits (low, high half), so
    that the row's 16-byte word ch is word i of planes 2ch, 8 + 2ch,
    2ch + 1 and 9 + 2ch. Warps then store whole 512-byte stretches of
    rows."""
    rows: int
    blocks: int
    stride: int          # rows + 1 rounded up to 4 mod 32: no bank conflicts
    smem_bytes: int      # 16 planes

    def span_start(self, block: int, dz: int, dy: int, yx: int,
                   x: int) -> int:
        return block * self.rows + dz * yx + dy * x


@functools.lru_cache(maxsize=64)
def table_tiling(grid_shape, rows: int = TABLE_ROWS) -> TableTiling:
    stride = rows + 1 + (4 - (rows + 1)) % 32
    return TableTiling(rows=rows,
                       blocks=-(-fullpitch_rows(grid_shape) // rows),
                       stride=stride, smem_bytes=16 * stride * 4)


@dataclass(frozen=True)
class GradTiling:
    """K4's and K5b's launch. A run is ``run`` voxels of one z-plane
    (in-plane index p * run + i, i < run, a thread each); block b owns run
    p = b % runs of planes [z0, z1) (:meth:`block_planes`) and marches up
    them. Run z sums table rows v - off over the 8 corners: those with
    dz = 0 from run z's staged slot, dz = 1 from run z - 1's, so a ring
    of two slots reads each slot's rows once. A slot holds the ``span``
    rows of :meth:`slot_rows`: first the dy = 1 rows from base - X - 1,
    then from staged index ``lead`` the dy = 0 rows from base - 1 (one
    span when X <= run + 1, two apart otherwise), column-major with
    ``stride`` 32-bit words a column: ``slot_cols`` 32 holds a float32
    row's 32 values (K4), 16 a 16-bit row's pair words as they came
    (K5b: column ch * 4 + k holds corners 2k and 2k + 1 of channel ch,
    low and high half). Voxel i's corner (dz, dy, dx) is staged index
    (0 if dy else lead) + i + 1 - dx; rows outside [0, n_cells) are
    staged as 0, which only voxels outside the grid or rows v - off < 0
    meet."""
    run: int
    z_chunk: int
    runs: int            # runs a z-plane: ceil(Y * X / run)
    blocks: int          # runs * ceil(Z / z_chunk)
    lead: int            # min(X, run + 1)
    span: int            # lead + run + 1
    stride: int          # span, made odd (2 mod 4 for 16 columns): no bank
    #                      conflicts
    smem_bytes: int      # 2 slots x slot_cols columns, 3 * run floats of
    #                      d_color
    slot_cols: int = NCH

    def block_planes(self, block: int, z: int) -> tuple:
        """(p, z0, z1) of block ``block`` in a grid of ``z`` planes."""
        z0 = block // self.runs * self.z_chunk
        return block % self.runs, z0, min(z0 + self.z_chunk, z)

    def slot_rows(self, p: int, zi: int, yx: int, x: int) -> torch.Tensor:
        """The table rows run ``zi`` of in-plane run ``p`` stages, in
        staged order (int64; some may lie outside the table)."""
        base = zi * yx + p * self.run
        ell = torch.arange(self.span, dtype=torch.int64)
        return torch.where(ell < self.lead, base - x - 1 + ell,
                           base - 1 + ell - self.lead)


@functools.lru_cache(maxsize=64)
def grad_tiling(grid_shape, run: int | None = None,
                z_chunk: int | None = None,
                slot_cols: int = NCH) -> GradTiling:
    """K4's launch: by default runs of 128 voxels up to X = 64 and of 256
    beyond (a slot reads about 1.5 rows a voxel at X = run / 2), and the
    longest z-chunk of 16, 8, 4 or 2 planes that still gives 2 blocks an
    SM (else 1). ``slot_cols`` 16 gives K5b's launch, over 16-bit
    slots."""
    if slot_cols not in (NCH, NCH // 2):
        raise ValueError(f"slot_cols: want 32 or 16, got {slot_cols}")
    z, y, x = (int(v) for v in grid_shape)
    if run is None:
        run = 128 if x <= 64 else 256
    runs = -(-(y * x) // run)
    if z_chunk is None:
        z_chunk = next((k for k in (16, 8, 4, 2)
                        if runs * -(-z // k) >= 2 * N_SMS), 1)
    lead = min(x, run + 1)
    span = lead + run + 1
    stride = span | 1 if slot_cols == NCH else span + (2 - span) % 4
    return GradTiling(run=run, z_chunk=z_chunk, runs=runs,
                      blocks=runs * -(-z // z_chunk), lead=lead, span=span,
                      stride=stride,
                      smem_bytes=(2 * slot_cols * stride + 3 * run) * 4,
                      slot_cols=slot_cols)


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
    tl = table_tiling(sigma.shape)
    lib = _build.library()
    with torch.cuda.device(sigma.device):
        code = lib.dvt_packed_table(
            sigma.data_ptr(), color.data_ptr(), out.data_ptr(),
            z, y, x, n_rows, tl.rows, tl.stride, tl.blocks, tl.smem_bytes,
            _build.stream_ptr(sigma.device))
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
    if table_grad.data_ptr() % 16:
        raise ValueError("table_grad must start on a 16-byte boundary")
    dev = table_grad.device
    d_sigma = torch.empty((z, y, x), dtype=torch.float32, device=dev)
    d_color = torch.empty((z, y, x, 3), dtype=torch.float32, device=dev)
    tl = grad_tiling((z, y, x))
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_packed_table_grad(
            table_grad.data_ptr(), d_sigma.data_ptr(), d_color.data_ptr(),
            z, y, x, tl.run, tl.z_chunk, tl.runs, tl.lead, tl.span,
            tl.stride, tl.blocks, tl.smem_bytes, _build.stream_ptr(dev))
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
    tl = table_tiling(sigma.shape)
    lib = _build.library()
    with torch.cuda.device(sigma.device):
        code = lib.dvt_packed_table16(
            sigma.data_ptr(), color.data_ptr(), out.data_ptr(),
            z, y, x, n_rows, kind, tl.rows, tl.stride, tl.blocks,
            tl.smem_bytes, _build.stream_ptr(sigma.device))
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
    if table_grad16.data_ptr() % 16:
        raise ValueError("table_grad16 must start on a 16-byte boundary")
    dev = table_grad16.device
    d_sigma = torch.empty((z, y, x), dtype=torch.float32, device=dev)
    d_color = torch.empty((z, y, x, 3), dtype=torch.float32, device=dev)
    tl = grad_tiling((z, y, x), slot_cols=NCH // 2)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.dvt_packed_table16_grad(
            table_grad16.data_ptr(), d_sigma.data_ptr(), d_color.data_ptr(),
            z, y, x, kind, tl.run, tl.z_chunk, tl.runs, tl.lead, tl.span,
            tl.stride, tl.blocks, tl.smem_bytes, _build.stream_ptr(dev))
    _build.check(code, "dvt_packed_table16_grad")
    table16_grad_to_params.launches += 1
    return d_sigma, d_color


table16_grad_to_params.launches = 0


# K6: bank blocks -> slot rows (the split tiled backward)
BANK_LANES = 128


def banks_to_rows_plain(banks: torch.Tensor) -> torch.Tensor:
    """Plain twin of K6: each (32, 128) block transposed, the blocks'
    rows stacked."""
    return banks.transpose(1, 2).reshape(-1, NCH).contiguous()


def banks_to_rows(banks: torch.Tensor) -> torch.Tensor:
    """(B, 32, 128) float32 bank-block cotangents -> (B*128, 32) slot
    rows, row s = lane s % 128 of block s // 128: one launch for every
    tile group of a backward. Every value is moved as a 32-bit word, NaN
    payloads and -0.0 included."""
    if banks.dim() != 3 or tuple(banks.shape[1:]) != (NCH, BANK_LANES):
        raise ValueError(f"banks: want shape (B, {NCH}, {BANK_LANES}), got "
                         f"{tuple(banks.shape)}")
    if banks.dtype != torch.float32:
        raise TypeError(f"banks: want torch.float32, got {banks.dtype}")
    if not banks.is_contiguous():
        raise ValueError("banks must be contiguous")
    if banks.device.type == "cpu":
        return banks_to_rows_plain(banks)
    if banks.device.type != "cuda":
        raise ValueError(f"unsupported device {banks.device}")
    dst = torch.empty((int(banks.shape[0]) * BANK_LANES, NCH),
                      dtype=torch.float32, device=banks.device)
    lib = _build.library()
    with torch.cuda.device(banks.device):
        code = lib.dvt_banks_to_rows(banks.data_ptr(), dst.data_ptr(),
                                     int(banks.shape[0]),
                                     _build.stream_ptr(banks.device))
    _build.check(code, "dvt_banks_to_rows")
    banks_to_rows.launches += 1
    return dst


banks_to_rows.launches = 0
