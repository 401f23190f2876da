"""The tile schedule and K1, the fused tile forward, against dvren_tpu.

The port's host schedule must equal ``build_tiled_schedule(...,
device=False)`` array for array (``gather_plan``, backward-only, is not
built). The plain K1 twin must stay within 5e-6 of the Pallas
``_fwd_kernel`` (interpret mode on the CPU) on every tile group, depth
within 1e-4. The CUDA kernel is held to the plain twin on the card
(tests/test_torch_cuda.py).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.ops import fused_tiles as j_ft
from dvren_tpu.ops import grid as j_grid
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests.test_tiled import scene
from tests.test_torch_core import port_field, port_plan

from dvren_tpu_torch.ops import fused_tiles as p_ft
from dvren_tpu_torch.ops import packed_transpose as p_pt
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
GROUP_FIELDS = ("hostmap", "gathermap", "samp", "base", "rayt", "bank0",
                "ray_ids", "k_enter", "pixel_ids", "tile_ids")
SCHEDULE_META = ("total_rays", "tiled_samples", "full_lattice_samples",
                 "fallback_rays", "grid_shape", "bbox", "tile_px",
                 "table_kind", "pitch", "cell_scale")
SCENES = ("fixed", "stratified", "roi", "opaque")


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX plan, JAX field, JAX numpy schedule, port plan, port field,
    port numpy schedule) for one scene."""
    kw = {"fixed": {}, "stratified": dict(mode=J.SamplingMode.STRATIFIED),
          "roi": dict(width=50, height=38,
                      roi=J.Roi(x=3, y=5, width=41, height=27)),
          "opaque": dict(mode=J.SamplingMode.STRATIFIED)}[name]
    plan, field = scene(**kw)
    if name == "opaque":   # dense enough that rays stop early
        field = field.with_params(field.sigma * 25.0, field.color)
    ref = j_tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), device=False)
    pplan, pfield = port_plan(plan), port_field(field)
    return plan, field, ref, pplan, pfield, p_tiled.build_tiled_schedule(
        pplan, pfield)


def assert_schedules_equal(ref, got):
    assert len(ref.groups) == len(got.groups)
    for gr, gp in zip(ref.groups, got.groups):
        assert (gr.n_chunks, gr.n_tiles, gr.banks, gr.samples) == \
            (gp.n_chunks, gp.n_tiles, gp.banks, gp.samples)
        for name in GROUP_FIELDS:
            a, b = np.asarray(getattr(gr, name)), getattr(gp, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("hostmap_all", "gathermap_all"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)))
    for name in SCHEDULE_META:
        assert getattr(got, name) == getattr(ref, name), name
    assert_fallbacks_equal(ref, got)


def assert_fallbacks_equal(ref, got):
    """The windowed fallback schedules, array for array: the port's is
    None wherever the reference's is (no overflow rays, or a schedule
    built without its fallback, as a cascade probe or on the grid path)."""
    if ref.fallback is None:
        assert got.fallback is None
        return
    a, b = ref.fallback, got.fallback
    assert (b.total_rays, b.skipped_rays, b.windowed_samples) == (
        a.total_rays, a.skipped_rays, a.windowed_samples)
    assert len(a.groups) == len(b.groups)
    for ga, gb in zip(a.groups, b.groups):
        assert ga[0] == gb[0]
        for x, y in zip(ga[1:], gb[1:]):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize("name", SCENES)
def test_schedule_leaves_equal(name):
    _, _, ref, _, _, got = case(name)
    assert ref.tiled_samples > 0
    assert_schedules_equal(ref, got)


def test_schedule_overflow_count_equal():
    """Tiles whose chunks touch more than 256 cells: both builders count
    the same overflow rays and keep the same groups."""
    cfg = J.PlanConfig(
        width=16, height=16, t_near=0.1, t_far=3.1, seed=17,
        camera=J.CameraConfig(k=(16.0, 0, 8.0, 0, 16.0, 8.0, 0, 0, 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -1.1)),
        sampling=J.SamplingConfig(dt=0.05, max_steps=60))
    plan = J.Plan.create(cfg)
    n = 128
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=np.ones(n ** 3), color=np.ones(3 * n ** 3)))
    ref = j_tiled.build_tiled_schedule(plan, field, device=False,
                                       build_fallback=False)
    got = p_tiled.build_tiled_schedule(port_plan(plan), port_field(field),
                                       build_fallback=False)
    assert got.fallback_rays > 0
    assert_schedules_equal(ref, got)


@pytest.mark.parametrize("name", ["fixed", "roi"])
def test_tile_rays_equal(name):
    plan = case(name)[0]
    for a, b in zip(j_tiled._tile_rays(plan, 16),
                    p_tiled._tile_rays(port_plan(plan))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_pack_runs_equal():
    rng = np.random.default_rng(5)
    flat = rng.integers(0, 300, size=(12, 2048)).astype(np.int64)
    flat[rng.random(flat.shape) < 0.4] = j_tiled._SENTINEL
    flat[3] = j_tiled._SENTINEL                       # an empty run
    flat[4] = rng.integers(0, 100, 2048)              # no sentinel
    ref = j_tiled._pack_runs_numpy(flat, 1, 257, 129)[:5]
    got = p_tiled._pack_runs_numpy(flat, 257)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", ["stratified", "roi"])
def test_bank_gather_equal(name):
    _, field, ref, _, pfield, got = case(name)
    shapes = [(g.n_tiles, g.banks) for g in ref.groups]
    tabs_ref = j_tiled._t16_to_banks(
        j_grid.build_packed_table16(field.sigma, field.color),
        ref.gathermap_all, (1, tuple(shapes)))
    table = p_pt.build_rows_plain(pfield.sigma.detach(), pfield.color.detach())
    tabs = p_tiled._gather_bank_tables(
        table, torch.from_numpy(got.gathermap_all), shapes)
    for a, b in zip(tabs_ref, tabs):
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(a).view(np.uint32))


def test_dead_lanes_read_row_zero():
    """-1 lanes read row 0 (JAX ``mode="clip"``), not torch's last row."""
    table = torch.arange(4 * 32, dtype=torch.float32).reshape(4, 32)
    gmap = torch.full((128,), -1, dtype=torch.int32)
    gmap[5] = 3
    (banks,) = p_tiled._gather_bank_tables(table, gmap, [(1, 1)])
    assert banks.shape == (1, 1, 32, 128)
    assert torch.equal(banks[0, 0, :, 5], table[3])
    assert torch.equal(banks[0, 0, :, 0], table[0])
    assert torch.equal(banks[0, 0, :, 127], table[0])


@pytest.mark.parametrize("name", SCENES)
def test_k1_plain_matches_reference(name):
    plan, field, ref, pplan, pfield, got = case(name)
    geom = (ref.bbox[0], ref.bbox[1], ref.grid_shape)
    shapes = [(g.n_tiles, g.banks) for g in ref.groups]
    tabs_ref = j_tiled._t16_to_banks(
        j_grid.build_packed_table16(field.sigma, field.color),
        ref.gathermap_all, (1, tuple(shapes)))
    sched = got.to("cpu")
    tabs = p_tiled._gather_bank_tables(
        p_pt.build_rows_plain(pfield.sigma.detach(), pfield.color.detach()),
        sched.gathermap_all, shapes)
    max_odp = 0.0
    for gi, (gr, gp) in enumerate(zip(ref.groups, sched.groups)):
        kp = j_ft.tile_op_params(plan, geom, gr.banks, gr.n_chunks, 1,
                                 gr.n_tiles)
        raw_ref = np.asarray(j_ft._tile_op(*kp).fwd_call(
            tabs_ref[gi], gr.samp, gr.base, gr.rayt,
            gr.k_enter.reshape(-1).astype(np.int32),
            gr.bank0.reshape(-1).astype(np.int32)))
        raw = p_ft.tile_forward_plain(
            tabs[gi], gp.samp, gp.base, gp.rayt, gp.k_enter,
            gp.bank0.reshape(-1),
            p_ft.tile_op_params(pplan, geom, gp.banks, gp.n_chunks))
        assert raw.shape == raw_ref.shape
        (r, g, b), t, o, d = p_ft.finalize_heads(pplan, raw)
        (rr, gg, bb), tt, oo, dd = j_ft.finalize_heads(plan, raw_ref)
        for x, y in ((r, rr), (g, gg), (b, bb), (t, tt), (o, oo)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=TOL)
        np.testing.assert_allclose(d.numpy(), np.asarray(dd), atol=TOL_DEPTH)
        max_odp = max(max_odp, float(raw[:, 4].max()))
    if name == "opaque":   # some ray reached T <= 1e-4 and stopped
        assert max_odp > -np.log(j_ft.STOP_THRESHOLD)


def test_tile_op_params_match_reference():
    plan, _, ref, pplan, _, got = case("roi")
    geom = (ref.bbox[0], ref.bbox[1], ref.grid_shape)
    g = got.groups[0]
    kp = j_ft.tile_op_params(plan, geom, g.banks, g.n_chunks, 1, g.n_tiles)
    prm = p_ft.tile_op_params(pplan, geom, g.banks, g.n_chunks)
    assert (prm.n_chunks, prm.banks) == (kp[0], kp[1])
    assert (prm.dt, prm.t_near, prm.t_far, prm.k_max, prm.stop) == kp[4:9]
    assert (prm.lo, prm.inv, prm.ns) == kp[12:15]


def test_decode_samples():
    rng = np.random.default_rng(2)
    st = rng.uniform(0.1, 3.0, (2, 3, 16, 128)).astype(np.float32)
    lane = rng.integers(0, 1 << 15, st.shape)
    mask = rng.integers(0, 2, st.shape)
    bits = st.view(np.uint32)
    samp = np.stack([(bits >> 16).astype(np.uint16),
                     (bits & 0xFFFF).astype(np.uint16),
                     (lane | (mask << 15)).astype(np.uint16)], axis=2)
    got_st, got_m, got_lane = p_ft.decode_samples(torch.from_numpy(samp))
    np.testing.assert_array_equal(got_st.numpy(), st.reshape(2, 3, 2048))
    np.testing.assert_array_equal(got_m.numpy(), mask.reshape(2, 3, 2048))
    np.testing.assert_array_equal(got_lane.numpy(), lane.reshape(2, 3, 2048))


def test_finalize_heads_matches_reference():
    plan, _, _, pplan, _, _ = case("fixed")
    rng = np.random.default_rng(4)
    raw = rng.uniform(0, 2, (3, 5, 16, 16)).astype(np.float32)
    raw[0, 4] = 0.0                  # transparent rays: depth = t_far
    raw[1, 4] = 1e-7
    got = p_ft.finalize_heads(pplan, torch.from_numpy(raw))
    ref = j_ft.finalize_heads(plan, raw)
    for a, b in zip(list(got[0]) + list(got[1:]),
                    list(ref[0]) + list(ref[1:])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def _group_args(name):
    """Per group of the scene's schedule (one-shape set, flat bank tables,
    TileParams of the launch)."""
    plan, _, ref, pplan, field, got = case(name)
    sched = got.to("cpu")
    geom = (ref.bbox[0], ref.bbox[1], ref.grid_shape)
    table = p_pt.build_rows_plain(field.sigma.detach(), field.color.detach())
    out = []
    for g in sched.groups:
        tiles = p_ft.tile_set([g], 1)
        tabs = p_tiled._gather_banks_flat(
            table, torch.from_numpy(g.gathermap.numpy()))
        out.append((tiles, tabs,
                    p_ft.tiles_op_params(pplan, geom, tiles)))
    return out


def test_wrapper_takes_plain_twin_on_cpu():
    """One group as a one-shape set: the wrapper runs K1's twin on the
    CPU, no launch counted."""
    tiles, tabs, prm = _group_args("fixed")[0]
    before = p_ft.tile_forward.launches
    out = p_ft.tile_forward(tabs, tiles, prm)
    assert p_ft.tile_forward.launches == before
    n, nc, nb = tiles.shapes[0]
    assert torch.equal(out, p_ft.tile_forward_plain(
        tabs.reshape(n, nb, 32, 128), tiles.samp.reshape(n, nc, 3, 16, 128),
        tiles.base.reshape(n, nb, 3, 128), tiles.rayt, tiles.ke, tiles.bank0,
        prm))


def test_wrapper_rejects_bad_inputs():
    tiles, tabs, prm = _group_args("fixed")[0]
    with pytest.raises(TypeError):
        p_ft.tile_forward(tabs, dataclasses.replace(
            tiles, samp=tiles.samp.to(torch.int32)), prm)
    with pytest.raises(ValueError):
        p_ft.tile_forward(tabs, dataclasses.replace(
            tiles, bank0=tiles.bank0[:-1]), prm)
    with pytest.raises(TypeError):
        p_ft.tile_forward(tabs, dataclasses.replace(
            tiles, ke=tiles.ke.long()), prm)
