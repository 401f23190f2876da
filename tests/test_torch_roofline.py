"""``utils/roofline.py`` and ``utils/timing.py`` of dvren_tpu_torch, on the
CPU.

The byte floor of a tiled frame against a hand count from the schedule's
group shapes (tests/test_tiled.py's scene, 48x32 over 8^3: 16 px cells
and 8 px supercells), and the timing helpers' contract on CPU calls.
The rates are the H100's published ones; nothing here is a device time.
"""

import numpy as np
import pytest
import torch

import dvren_tpu as J
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan

from dvren_tpu_torch.render import tiled as p_tiled
from dvren_tpu_torch.utils import roofline, timing

torch.set_num_threads(1)


def schedule(**kw):
    plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED)
    pp = port_plan(plan)
    return pp, p_tiled.build_tiled_schedule(pp, port_field(field), **kw)


def hand_count(pp, sched, width, table_rows, item=4):
    """Each phase's bytes from the groups' shapes, element by element."""
    cells = 8 ** 3
    table = table_rows * width * item
    slots = banks_in = rayt = ke = samp = bank0 = desc = heads = 0
    subs = sched.subs
    for g in sched.groups:
        t, nc, nb = g.n_tiles, g.n_chunks, g.banks
        slots += t * nb * 128
        banks_in += t * nb * 3 * 128 * 4       # base: f32 (nb, 3, 128)
        rayt += t * 12 * 128 * 4
        ke += t * 4
        samp += t * nc * 3 * 16 * 128 * 2      # u16 (nc, 3, 16, 128)
        bank0 += t * nc * subs * 4
        desc += t * 4 * 4
        heads += t * 5 * 16 * 16 * 4
    gathered = slots * width * 4
    return {
        "table": cells * 16 + table,
        "bank_gather": table + sched.gathermap_all.size * 4 + gathered,
        "kernel": gathered + banks_in + rayt + ke + samp + bank0 + desc
        + heads,
        "compose": heads + pp.ray_count * 7 * 4,
    }


@pytest.mark.parametrize("form", ["cell", "super"])
def test_forward_streams_match_a_hand_count(form):
    if form == "cell":
        pp, sched = schedule()
        want = hand_count(pp, sched, 32, 2048)     # 8^3 rows padded
    else:
        pp, sched = schedule(tile_px=8, cell_scale=2)
        want = hand_count(pp, sched, 108, 4 ** 3)
    streams = roofline.forward_streams(sched)
    got = {k: v["bytes"] for k, v in streams["phases"].items()}
    assert got == want
    assert streams["totals"]["bytes"] == sum(want.values())
    # the same on the device copy of the schedule
    moved = roofline.forward_streams(sched.to("cpu"))
    assert {k: v["bytes"] for k, v in moved["phases"].items()} == want


def test_sixteen_bit_rows_halve_the_table():
    pp, sched = schedule()
    f32 = roofline.forward_streams(sched)["phases"]
    b16 = roofline.forward_streams(sched, table_dtype="bfloat16")["phases"]
    half = 2048 * 32 * 2
    assert f32["table"]["bytes"] - b16["table"]["bytes"] == half
    assert f32["bank_gather"]["bytes"] - b16["bank_gather"]["bytes"] == half
    assert f32["kernel"] == b16["kernel"]


def test_floor_and_roofline():
    pp, sched = schedule()
    streams = roofline.forward_streams(sched)
    floors = roofline.floor_ms(streams)
    for name, p in streams["phases"].items():
        assert floors[name] == pytest.approx(p["bytes"] / 3.35e12 * 1e3)
    assert floors["total"] == pytest.approx(
        sum(v for k, v in floors.items() if k != "total"))
    line = roofline.forward_roofline(sched, measured_ms=2.0)
    assert line["rate_bytes_s"] == 3.35e12
    assert line["bytes_per_frame"] == streams["totals"]["bytes"]
    assert line["measured_over_floor"] == pytest.approx(
        2.0 / floors["total"])
    assert "measured_ms" not in roofline.forward_roofline(sched)


def test_timing_helpers_on_cpu_calls():
    calls = []

    def fn(x):
        calls.append(float(x[0]))
        return (x * 2.0, {"other": x})

    variants = [(torch.ones(4),), (torch.full((4,), 3.0),)]
    assert timing.fetch_probe(fn(*variants[1])) == 6.0
    calls.clear()
    stats = timing.time_calls(fn, variants, iters=5, warmup=2)
    assert calls == [1.0, 3.0, 1.0, 3.0, 1.0, 3.0, 1.0]
    assert len(stats["per_call_s"]) == 5
    assert stats["min_s"] <= stats["median_s"] <= stats["max_s"]
    assert stats["mean_s"] == pytest.approx(np.mean(stats["per_call_s"]))
    assert timing.time_compiled(fn, variants, iters=3) > 0.0
