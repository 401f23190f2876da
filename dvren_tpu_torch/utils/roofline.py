"""The byte floor of the tiled forward on the H100, phase by phase.

Counterpart of ``dvren_tpu/utils/roofline.py``, which priced the JAX
forward's streams against a TPU's measured rates. This module prices the
port's own forward over a :class:`~dvren_tpu_torch.render.tiled.TiledSchedule`
(``render/tiled.py::_GroupsetFromParams`` and ``_compose_tiles``):

1. ``table``: K3 (``csrc/packed_table.cu``) reads sigma and colour (4
   float32 a cell) and writes the (R, 32) float32 rows (R the cells
   rounded up to 2048, ``ops/grid.py::fullpitch_rows``); K5a the same
   rows in 16 bits; a supercell schedule the (R_s, 108) float32 stencil;
2. ``bank_gather``: the table, the gather map and the (S, w, 128) float32
   bank blocks the kernel reads (``_gather_banks_flat``);
3. ``kernel``: K1 (``csrc/fused_tiles.cu``) reads the bank blocks and the
   tile set's arrays and writes 5 heads of 16 x 16 float32 a tile;
4. ``compose``: the heads read, the image planes written (RGB, T,
   opacity, depth in float32, the int32 hitmask).

Each input is counted once and each output once, whatever a kernel reads
again (the gather reads a table row once per slot that names it; those
re-reads mostly hit the 50 MB L2). The rate is the H100 SXM's published
HBM rate, 3.35 TB/s (NVIDIA's data sheet), and the floor of a phase is
its bytes over that rate; the phases depend on each other, so the frame's
floor is their sum. There is no gather-start term: the TPU's bank gather
paced by DMA element starts, but on the card a gather is one warp-wide
load of a contiguous 128-byte (or 432-byte) row, priced by its bytes like
any other read. ``chip_smoke.py`` reads this module's ``table`` and
``kernel`` bytes for K3's and K1's bounds, where K1's also weighs its
float work (116 operations a live sample against 67 TFLOP/s).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
HEADS = 5                 # K1's output heads a pixel
TILE_PIXELS = 16 * 16
PLANE_WORDS = 7           # RGB, T, opacity, depth (float32), hitmask (int32)
_ITEM = {"float32": 4, "bfloat16": 2, "float16": 2}


def _nbytes(x) -> int:
    """Bytes of a numpy array or a tensor."""
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    return int(x.numel()) * int(x.element_size())


def forward_streams(sched, table_dtype: str = "float32",
                    pixels: int | None = None) -> dict:
    """The bytes each phase of one tiled frame over ``sched`` must move:
    ``{"phases": {name: {"bytes": B}}, "totals": {"bytes": sum}}``.
    ``table_dtype`` is the field's ``packed_dtype`` (16-bit rows for
    K5a); ``pixels`` the frame's pixels (default the schedule's rays)."""
    from dvren_tpu_torch.ops.grid import (SUPER_NCH, fullpitch_rows,
                                          supercell_rows)

    cells = int(np.prod(sched.grid_shape))
    if sched.cell_scale == 2:
        width, item = SUPER_NCH, 4
        rows = supercell_rows(tuple(sched.grid_shape))
    else:
        width, item = 32, _ITEM[table_dtype]
        rows = fullpitch_rows(tuple(sched.grid_shape))
    table_bytes = rows * width * item
    params_bytes = cells * 4 * 4          # sigma and three colours

    tiles = sched.tile_set()
    slots = int(sum(g.n_tiles * g.banks for g in sched.groups)) * 128
    banks_bytes = slots * width * 4       # widened to float32
    n_tiles = int(sum(g.n_tiles for g in sched.groups))
    heads_bytes = n_tiles * HEADS * TILE_PIXELS * 4
    tile_arrays = sum(_nbytes(x) for x in (
        tiles.samp, tiles.base, tiles.rayt, tiles.ke, tiles.bank0,
        tiles.desc))
    if pixels is None:
        pixels = int(sched.total_rays)
    phases = {
        "table": {"bytes": params_bytes + table_bytes},
        "bank_gather": {"bytes": table_bytes + _nbytes(sched.gathermap_all)
                        + banks_bytes},
        "kernel": {"bytes": banks_bytes + tile_arrays + heads_bytes},
        "compose": {"bytes": heads_bytes + pixels * PLANE_WORDS * 4},
    }
    return {"phases": phases,
            "totals": {"bytes": sum(p["bytes"] for p in phases.values())}}


def floor_ms(streams: dict, bytes_per_s: float = HBM_BYTES_S) -> dict:
    """Each phase's bytes over ``bytes_per_s``, in ms, and their sum
    (``"total"``)."""
    out = {name: p["bytes"] / bytes_per_s * 1e3
           for name, p in streams["phases"].items()}
    out["total"] = sum(out.values())
    return out


def forward_roofline(sched, measured_ms: float | None = None,
                     bytes_per_s: float = HBM_BYTES_S,
                     table_dtype: str = "float32",
                     pixels: int | None = None) -> dict:
    """The floor of one tiled frame over ``sched``: the rate, the frame's
    bytes, each phase's floor and their sum in ms, and, given a measured
    frame time, the measured time over the floor."""
    streams = forward_streams(sched, table_dtype, pixels)
    floors = floor_ms(streams, bytes_per_s)
    out = {
        "rate_bytes_s": bytes_per_s,
        "rate_source": "H100 SXM HBM3, NVIDIA data sheet",
        "bytes_per_frame": streams["totals"]["bytes"],
        "phase_bytes": {k: p["bytes"] for k, p in streams["phases"].items()},
        "floor_ms": floors,
    }
    if measured_ms is not None:
        out["measured_ms"] = float(measured_ms)
        out["measured_over_floor"] = float(measured_ms) / floors["total"]
    return out
