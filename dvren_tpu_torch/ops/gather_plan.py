"""Gather-only transposes of many-to-one row gathers.

A gather ``out[i] = table[rows[i]]`` has a scatter-add for its transpose,
and on CUDA a scatter-add (``index_add_``, ``index_put_(accumulate=True)``)
adds with float atomics in a run-dependent order. A :class:`GatherPlan`,
built once on the host from ``rows``, lets the transpose run as gathers
and sums in a fixed order instead, so repeat runs are bit-identical.

Two callers: the tiled renderer's bank gather (slot rows to packed table
rows, ``render/tiled.py``) and the hash grid table build's adjoint (level
vertices to hash entries, ``ops/hash_grid.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def _on(x, device):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x.to(device)


@dataclass(frozen=True)
class GatherPlan:
    """The transpose of a row gather (see :func:`build_gather_plan`).
    ``meta`` = per exact-count class (offset into ``all_idx``, cells n_k,
    slots per cell c_k)."""

    all_idx: np.ndarray      # (S_live,) int32 slot rows, grouped by cell
    inv_map: np.ndarray      # (n_cells,) int32 class-order row per table
    #                          row; inactive rows name the trailing zero row
    meta: tuple

    def to(self, device) -> "GatherPlan":
        return dataclasses.replace(
            self, all_idx=_on(self.all_idx, device),
            inv_map=_on(self.inv_map, device))


def build_gather_plan(hostmap_all: np.ndarray, n_cells: int,
                      slot_key: np.ndarray | None = None
                      ) -> GatherPlan | None:
    """The transpose of the gather ``slot[i] = table[hostmap_all[i]]``, as
    gathers and sums only.

    The live slot rows (dead lanes, -1, carry exact zeros and are left
    out) are sorted by the table row (cell) they gather, and the cells are
    bucketed into exact-count classes: ``all_idx`` concatenates every
    class's (n_k, c_k) block of slot rows, so the backward takes ONE
    gather of the slot rows, sums each cell's c_k rows, and assembles the
    (n_cells, w) table gradient by the inverse-permutation gather
    ``inv_map`` (untouched cells read a trailing zero row). None for an
    empty schedule. ``slot_key`` (S,): each cell's rows in rising key
    order (and so their sum's order), by default slot order. Equal to
    ``dvren_tpu``'s plan array for array where the key rises with the
    slot index."""
    if hostmap_all.size == 0:
        return None
    valid = np.nonzero(hostmap_all >= 0)[0].astype(np.int64)
    if valid.size == 0:
        return None
    if slot_key is None:
        order = valid[np.argsort(hostmap_all[valid], kind="stable")]
    else:
        order = valid[np.lexsort((slot_key[valid], hostmap_all[valid]))]
    cells, first, counts = np.unique(
        hostmap_all[order], return_index=True, return_counts=True)
    idx_parts, meta, cell_order = [], [], []
    off = 0
    for v in np.unique(counts):
        member = counts == v
        n_k, c_k = int(member.sum()), int(v)
        col = np.arange(c_k, dtype=np.int64)[None, :]
        idx_parts.append(
            order[first[member][:, None] + col].astype(np.int32).reshape(-1))
        cell_order.append(cells[member])
        meta.append((off, n_k, c_k))
        off += n_k * c_k
    cell_order = np.concatenate(cell_order)
    inv_map = np.full(n_cells, cell_order.size, np.int32)
    inv_map[cell_order] = np.arange(cell_order.size, dtype=np.int32)
    return GatherPlan(all_idx=np.concatenate(idx_parts), inv_map=inv_map,
                      meta=tuple(meta))


def slot_rows_to_table(rows: torch.Tensor, plan: GatherPlan | None,
                       n_cells: int) -> torch.Tensor:
    """Per-slot table-gradient rows (S, w) -> the (n_cells, w) table
    gradient: the f32 counterpart of ``dvren_tpu``'s
    ``ct16_rows_to_table16`` (and, at any w, the backward of its
    ``_gather_banks_f32``). One gather of the live slot rows in the
    plan's class order, a sum over each cell's c_k rows per exact-count
    class, and an inverse-permutation gather with a trailing zero row for
    the cells no slot names. Gathers and sums only: no ``index_add_`` or
    scatter, whose float atomics on CUDA add in a run-dependent order."""
    if plan is None:
        return rows.new_zeros((n_cells, rows.shape[1]))
    g = torch.index_select(rows, 0, plan.all_idx)
    parts = []
    for off, n_k, c_k in plan.meta:
        block = g[off:off + n_k * c_k]
        parts.append(block if c_k == 1 else
                     block.reshape(n_k, c_k, -1).sum(dim=1))
    parts.append(rows.new_zeros((1, rows.shape[1])))
    return torch.index_select(torch.cat(parts), 0, plan.inv_map)
