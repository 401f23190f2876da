"""The frozen K1 / K2 byte counts against a hand count of the arrays the
kernels take, on a one-group schedule the port builds on the CPU."""

import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import packed_transpose
from dvren_tpu_torch.render import tiled
from dvren_tpu_torch.render.pipeline import plan_jitter_table

from bench_port.counts import tiles as counts
from bench_port.lib import scene as S
from bench_port.reference import dense_grid as ref


@pytest.fixture(scope="module", params=[(8, 1), (16, 2)],
                ids=["cell_8px", "supercell_16px"])
def built(request):
    sc = ref.Scene(32, 32, 38.4, 0.2, 2.2, 32, 2 ** 31 + 17)
    plan = S.plan(P, sc, ref.orbit_c2w(0, 4, 0.25, 0.15))
    sigma, color = ref.blob_grid(16, 12.0, 0.05, (0.5, 0.5, 0.45), "cpu")
    field = P.DenseGridField(sigma, color)
    sched = tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), quantize="uniform",
        tile_px=request.param[0], cell_scale=request.param[1])
    assert len(sched.groups) == 1
    if request.param[1] == 1:
        table = packed_transpose.build_rows_plain(sigma, color)
    else:
        from dvren_tpu_torch.ops.grid import build_supercell_stencil
        table = build_supercell_stencil(sigma, color)
    tabs = tiled._gather_banks_flat(table, torch.from_numpy(
        np.asarray(sched.gathermap_all)), sched.pitch)
    return sched, tabs


def _hand_inputs(sched, tabs):
    t = sched.tiles
    arrays = (t.samp, t.base, t.rayt, t.ke, t.bank0, t.desc, t.order)
    return tabs.numel() * 4 + sum(int(np.asarray(a).nbytes) for a in arrays)


def test_k1_bytes(built):
    sched, tabs = built
    cols = int(tabs.shape[1])
    n_tiles = sched.tiles.n_tiles
    hand = _hand_inputs(sched, tabs) + n_tiles * 5 * 16 * 16 * 4
    assert counts.k1_bytes(sched.tiles.shapes, sched.subs, cols) == hand


def test_k2_bytes(built):
    sched, tabs = built
    cols = int(tabs.shape[1])
    n_tiles = sched.tiles.n_tiles
    heads = n_tiles * 5 * 16 * 16 * 4
    rows = sched.tiles.n_bank_rows * 128 * cols * 4
    hand = _hand_inputs(sched, tabs) + heads + rows
    assert counts.k2_bytes(sched.tiles.shapes, sched.subs, cols) == hand


def test_step_ops():
    assert counts.step_ops(10, False) == 10 * (116 + 221)
    assert counts.step_ops(10, True) == 10 * (116 + 221 + 6)
