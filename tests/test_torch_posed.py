"""dvren_tpu_torch's PosedRenderer against dvren_tpu's (render/posed.py).

JAX's scene of ``tests/test_posed.py`` (a 16^3 Gaussian blob under 128^2
rays, 32 stratified steps) at the base pose and three oblique orbit
poses, both packages in the split mode on the CPU (the JAX renderer with
``use_kernel=False``).

- The pins equal JAX's. Given the same ray planes, every array of the
  schedule (lane | mask and sample-depth words, hostmap, bank0, k_enter,
  base, rayt) and the diagnostics equal JAX's build run op by op, array
  for array, at every pose. Under ``jax.jit`` (JAX's own ``render`` and
  ``schedule_for``) XLA's CPU backend contracts a sample's position
  ``o + d * t`` into an FMA and fuses ``1 / sqrt`` of the directions;
  the port rounds each product and sum on its own on every device, as
  the host schedule build and the kernels do. Against JAX's jitted
  schedule,
  hostmap, bank0, k_enter, the cell bases, the sample depths and the
  diagnostics stay equal, the directions differ by at most two ulps,
  and a lane word moves only at a sample whose position lands in another
  cell (or on the other side of the bbox) under XLA's rounding: measured,
  one of 524,288 at the base pose and at the last orbit pose, none at
  the other two.
- Images within 5e-6 of JAX's posed image, and within 1e-5 of the port's
  own host-built tiled and windowed frames at the same pose (JAX's bound).
- JAX's six tests: the orbit against the windowed frame, the host tiled
  frame, determinism, the fixed mode, the pin guards, the schedule's
  structure.
- The two reference defects the port does not copy: a render re-checks
  the field (nearest, clamp, 16-bit and sparse fields raise), and the
  probe counts every z-slice of a run (JAX stops at 32).
- ``fused=True`` (graph mode) and ``render_sweep`` are refused on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table as j_jitter_table
from dvren_tpu.render.posed import PosedRenderer as JPosed
from dvren_tpu.render.windowed import build_schedule as j_window_schedule
from dvren_tpu.render.windowed import render_windowed_traced
from tests.test_posed import (BASE_C2W, ORBIT, STEPS, G, H, W, _field,
                              _plan)
from tests.test_torch_core import port_field, port_plan

import dvren_tpu as J
import dvren_tpu_torch as P
from dvren_tpu_torch.render import posed as p_posed
from dvren_tpu_torch.render import tiled as p_tiled
from dvren_tpu_torch.render import windowed as p_windowed
from dvren_tpu_torch.render.pipeline import plan_jitter_table
from dvren_tpu_torch.utils import trace

torch.set_num_threads(1)

POSES = {"base": BASE_C2W, "orbit0": ORBIT[0], "orbit1": ORBIT[1],
         "orbit2": ORBIT[2]}
# lane words of JAX's jitted schedule that differ from the port's, at
# most (the measured counts are 1, 0, 0, 1; see the module docstring)
LANE_WORDS_MOVED = 2


@pytest.fixture
def tracing_on():
    trace.reset()
    trace.enable(True)
    yield
    trace.enable(False)
    trace.reset()


@functools.lru_cache(maxsize=None)
def renderers():
    """(JAX renderer, JAX field, port renderer, port field), built once."""
    field = _field()
    jr = JPosed(_plan(BASE_C2W), field, use_kernel=False)
    pf = port_field(field)
    pr = p_posed.PosedRenderer(port_plan(_plan(BASE_C2W)), pf)
    return jr, field, pr, pf


@functools.lru_cache(maxsize=None)
def jax_pose(name):
    """JAX's schedule arrays, diagnostics, ray planes and image at a
    pose."""
    jr, field, _, _ = renderers()
    plan = _plan(POSES[name])
    k, c2w = jr._cam_arrays(plan)
    sched, diag = jax.jit(jr._build_schedule)(k, c2w, jr._consts)
    o, d = jax.jit(jr._tile_rays_planes)(k, c2w)
    g = sched.groups[0]
    arrays = {n: np.asarray(getattr(g, n)) for n in (
        "samp", "hostmap", "bank0", "k_enter", "base", "rayt")}
    image = np.asarray(jr.render(plan, field).image)
    return (arrays, np.asarray(diag), [np.asarray(x) for x in o],
            [np.asarray(x) for x in d], image)


def port_arrays(sched) -> dict:
    g = sched.groups[0]
    return {n: getattr(g, n).numpy() for n in (
        "samp", "hostmap", "bank0", "k_enter", "base", "rayt")}


def test_pins_equal_jax():
    jr, _, pr, _ = renderers()
    assert (pr.nc_pin, pr.nb_pin, pr.ez_pin) == (jr.nc_pin, jr.nb_pin,
                                                 jr.ez_pin)


@pytest.mark.parametrize("name", sorted(POSES))
def test_schedule_equals_jax_op_by_op(name, monkeypatch):
    """Given the port's ray planes, JAX's build run op by op (no jit)
    gives every array of the port's schedule and its diagnostics."""
    jr, _, pr, _ = renderers()
    plan = _plan(POSES[name])
    cam = pr._cam_arrays(port_plan(plan))
    o, d = pr._tile_rays_planes(*cam)
    monkeypatch.setattr(jr, "_tile_rays_planes", lambda k, c2w: (
        [jnp.asarray(x.numpy()) for x in o],
        [jnp.asarray(x.numpy()) for x in d]))
    sched, diag = jr._build_schedule(*jr._cam_arrays(plan), jr._consts)
    want = {n: np.asarray(getattr(sched.groups[0], n)) for n in (
        "samp", "hostmap", "bank0", "k_enter", "base", "rayt")}
    got_sched, got_diag = pr._build_schedule(*cam)
    got = port_arrays(got_sched)
    for key, a in want.items():
        np.testing.assert_array_equal(got[key], a.reshape(got[key].shape),
                                      err_msg=key)
    np.testing.assert_array_equal(got_diag.numpy(), np.asarray(diag))


def _plan_at(c2w, focal=1.2):
    """tests/test_posed.py's plan with the focal length ``focal`` x W."""
    return J.Plan.create(J.PlanConfig(
        width=W, height=H, t_near=0.2, t_far=2.2, seed=3,
        camera=J.CameraConfig(k=(W * focal, 0, W / 2, 0, W * focal, H / 2,
                                 0, 0, 1), c2w=c2w),
        sampling=J.SamplingConfig(dt=2.0 / STEPS, max_steps=STEPS,
                                  mode=J.SamplingMode.STRATIFIED)))


def _orbit_c2w(i, n=120, amp_x=0.1, amp_y=0.05, tz=-1.0):
    """Pose ``i`` of the benchmark's translation orbit
    (bench_port/reference/dense_grid.py::orbit_c2w)."""
    ang = 2.0 * np.pi * i / n
    return (1.0, 0.0, 0.0, 0.5 + amp_x * np.sin(ang), 0.0, 1.0, 0.0,
            0.5 + amp_y * np.cos(ang), 0.0, 0.0, 1.0, tz)


# the build's edge cases: (pose, focal scale, ez_pin below the pose's)
EDGE_CASES = {
    "tiles_miss": ((1, 0, 0, 1.3, 0, 1, 0, 0.5, 0, 0, 1, -1.0), 1.2, 0),
    "bank_run": (BASE_C2W, 1.0, 0),
    "past_ez_pin": (BASE_C2W, 1.2, 3),
    "orbit_x_max": (_orbit_c2w(30), 1.2, 0),
    "orbit_x_min": (_orbit_c2w(90), 1.2, 0),
}


def _twin_stats(pr, plan):
    """The twin's (run lanes (T, nc), offsets (T, nc)) at ``plan``."""
    o, d = pr._tile_rays_planes(*pr._cam_arrays(plan))
    tke, _ = pr._mask_full(o, d, pr._jt_k)
    _, ix, iy, iz, m = pr._window_lattice(o, d, tke, pr.nc_pin, pr._jt_k)
    run_lanes = pr._run_stats(ix, iy, iz, m, pr.ez_pin)[3]
    return run_lanes, pr._pack_offsets(run_lanes)[1]


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_schedule_edge_cases_equal_jax_op_by_op(case, monkeypatch):
    """The twin the build kernel is held to, against JAX's build run op by
    op at the cases the orbit lacks: tiles that miss the bbox (their runs
    empty, anchored at lane 0), runs over 128 lanes that start at a bank
    boundary, slices at or past ``ez_pin`` (counted in the diagnostics,
    in no box), and the benchmark orbit's two x extremes at 128^2."""
    c2w, focal, ez_cut = EDGE_CASES[case]
    jplan = _plan_at(c2w, focal)
    plan = port_plan(jplan)
    field = _field()
    pf = port_field(field)
    pr = p_posed.PosedRenderer(plan, pf)
    pins = dict(nc_pin=pr.nc_pin, nb_pin=pr.nb_pin, ez_pin=pr.ez_pin)
    if ez_cut:              # below the pose's slices (the probe adds 2)
        pins["ez_pin"] -= 2 + ez_cut
        pr = p_posed.PosedRenderer(plan, pf, **pins)
    jr = JPosed(jplan, field, use_kernel=False, **pins)
    cam = pr._cam_arrays(plan)
    o, d = pr._tile_rays_planes(*cam)
    monkeypatch.setattr(jr, "_tile_rays_planes", lambda k, c2w: (
        [jnp.asarray(x.numpy()) for x in o],
        [jnp.asarray(x.numpy()) for x in d]))
    sched, diag = jr._build_schedule(*jr._cam_arrays(jplan), jr._consts)
    got_sched, got_diag = pr._build_schedule(*cam)
    got = port_arrays(got_sched)
    for key in got:
        np.testing.assert_array_equal(
            got[key], np.asarray(getattr(sched.groups[0], key)).reshape(
                got[key].shape), err_msg=key)
    np.testing.assert_array_equal(got_diag.numpy(), np.asarray(diag))
    run_lanes, off = _twin_stats(pr, plan)
    if case == "tiles_miss":
        empty = (run_lanes == 0).all(dim=1).numpy()
        assert 0 < empty.sum() < len(empty)
        assert (got["k_enter"][empty] == 0).all()
        assert (got["bank0"][empty] == 0).all()
        assert (got["samp"][empty, :, 2] & 0x7FFF == 0).all()
        assert (got["hostmap"].reshape(len(empty), -1)[empty] == 0).all()
    elif case == "bank_run":
        prev_end = torch.cat([torch.zeros_like(off[:, :1]),
                              (off + run_lanes)[:, :-1]], dim=1)
        moved = (run_lanes > 128) & (off != prev_end)
        assert moved.any() and int(run_lanes.max()) <= 256
        assert (off[moved] % 128 == 0).all()
    elif case == "past_ez_pin":
        assert int(got_diag[2]) > pr.ez_pin
        with pytest.raises(P.DvrenError, match="ez_pin"):
            pr.render(plan, pf)
    else:
        pr._check_diag(got_diag)


def test_the_twin_builds_on_the_cpu(tracing_on):
    """On the CPU the torch twin builds every schedule: no build kernel
    launch, the twin's stages, and ``posed.kernel_frames`` stays 0."""
    from dvren_tpu_torch.ops import posed_build

    _, _, pr, pf = renderers()
    assert not pr.kernel_build
    n = posed_build.posed_build.launches
    for c2w in ORBIT:
        pr.render(port_plan(_plan(c2w)), pf)
    snap = trace.snapshot()
    assert posed_build.posed_build.launches == n
    assert snap["counters"].get("posed.kernel_frames", 0) == 0
    stages = snap["stages"]["posed.render"]["stages"]
    assert "build" not in stages and "run_stats" in stages


def _cells(o, d, st, contract):
    """Per axis (cell index, inside the bbox) of ``o + d * st`` on the
    test scene's grid: rounded once (an FMA) or twice."""
    if contract:
        pos = (np.float64(o) + np.float64(d) * np.float64(st)).astype(
            np.float32)
    else:
        pos = np.float32(np.float32(d) * np.float32(st)) + np.float32(o)
    local = np.float32(pos)          # bbox [0, 1]: (pos - 0) * 1
    inside = bool(0.0 <= local <= 1.0)
    cell = int(np.clip(np.floor(local * np.float32(G - 1)), 0, G - 2))
    return cell, inside


@pytest.mark.parametrize("name", sorted(POSES))
def test_schedule_equals_jax(name):
    """Against JAX's jitted schedule: hostmap, bank0, k_enter, the cell
    bases, the sample depths and the diagnostics equal; a direction
    differs by at most two ulps; at most LANE_WORDS_MOVED lane words
    differ, each at a sample that XLA's rounding (an FMA on JAX's rays)
    puts in another cell, or on the other side of the bbox, than the
    port's (two roundings on its own rays)."""
    want, want_diag, jo, jd, _ = jax_pose(name)
    _, _, pr, _ = renderers()
    sched = pr.schedule_for(port_plan(_plan(POSES[name])))
    got = port_arrays(sched)
    for key in ("hostmap", "bank0", "k_enter", "base"):
        np.testing.assert_array_equal(got[key],
                                      want[key].reshape(got[key].shape),
                                      err_msg=key)
    np.testing.assert_array_equal(got["samp"][:, :, :2],
                                  want["samp"][:, :, :2])
    _, diag = pr._build_schedule(*pr._cam_arrays(port_plan(
        _plan(POSES[name]))))
    np.testing.assert_array_equal(diag.numpy(), want_diag)
    rayt = got["rayt"].reshape(-1, 6, 256)
    want_rayt = want["rayt"].reshape(-1, 6, 256)
    np.testing.assert_array_equal(rayt[:, :3], want_rayt[:, :3])   # origins
    off = np.abs(rayt[:, 3:] - want_rayt[:, 3:]).max(axis=1)  # (T, 256)
    assert off.max() <= 2.0 ** -22          # unit directions: <= 2 ulps
    lane, want_lane = got["samp"][:, :, 2], want["samp"][:, :, 2]
    moved = np.argwhere(lane != want_lane)          # (t, c, row, lane)
    assert len(moved) <= LANE_WORDS_MOVED
    words = got["samp"].astype(np.uint32)
    for t, c, row, ln in moved:
        st = np.array((words[t, c, 0, row, ln] << 16)
                      | words[t, c, 1, row, ln], np.uint32).view(np.float32)
        ray = row * 16 + ln // 8
        port = [_cells(rayt[t, ax, ray], rayt[t, 3 + ax, ray], st, False)
                for ax in range(3)]
        xla = [_cells(jo[ax][t, ray], jd[ax][t, ray], st, True)
               for ax in range(3)]
        assert port != xla, (t, c, row, ln)


@pytest.mark.parametrize("name", sorted(POSES))
def test_images_match_jax_and_host_built(name):
    """Within 5e-6 of JAX's posed image, within 1e-5 of the port's host
    tiled and windowed frames (and the scene visible)."""
    _, _, _, _, want = jax_pose(name)
    _, _, pr, pf = renderers()
    plan = port_plan(_plan(POSES[name]))
    got = pr.render(plan, pf).image.numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    jitter = plan_jitter_table(plan)
    host = p_tiled.build_tiled_schedule(plan, pf, jitter=jitter).to("cpu")
    with torch.no_grad():
        tiled = p_tiled.render_tiled(plan, pf, host).image.numpy()
    ws = p_windowed.build_schedule(plan, pf.bbox_min, pf.bbox_max,
                                   jitter=jitter, device="cpu")
    with torch.no_grad():
        windowed = p_windowed.render_windowed(plan, pf, ws).image.numpy()
    assert np.abs(got - tiled).max() < 1e-5
    assert np.abs(got - windowed).max() < 1e-5
    assert got.mean() > 0.05


def test_posed_matches_windowed_over_orbit():
    """JAX's ``test_posed_matches_windowed_over_orbit``: the port's posed
    frames against JAX's windowed reference."""
    jr, field, pr, pf = renderers()
    for c2w in [BASE_C2W] + ORBIT:
        p = _plan(c2w)
        ws = j_window_schedule(p, field.bbox_min, field.bbox_max,
                               jitter=j_jitter_table(p))
        want = np.asarray(render_windowed_traced(p, field, ws).image)
        got = pr.render(port_plan(p), pf).image.numpy()
        assert np.abs(got - want).max() < 1e-5, c2w


def test_posed_matches_host_tiled():
    _, field, pr, pf = renderers()
    p = _plan(ORBIT[0])
    ts = j_tiled.build_tiled_schedule(p, field, jitter=j_jitter_table(p))
    want = np.asarray(j_tiled.render_tiled(p, field, ts,
                                           use_kernel=False).image)
    got = pr.render(port_plan(p), pf).image.numpy()
    assert np.abs(got - want).max() < 1e-5


def test_posed_deterministic():
    _, _, pr, pf = renderers()
    p = port_plan(_plan(ORBIT[1]))
    a = pr.render(p, pf)
    b = pr.render(p, pf)
    for key in ("image", "transmittance", "opacity", "depth"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key


def test_posed_fixed_mode():
    field = _field()
    base = _plan(BASE_C2W, mode=J.SamplingMode.FIXED)
    p = _plan(ORBIT[2], mode=J.SamplingMode.FIXED)
    jr = JPosed(base, field, use_kernel=False)
    pf = port_field(field)
    pr = p_posed.PosedRenderer(port_plan(base), pf)
    assert (pr.nc_pin, pr.nb_pin, pr.ez_pin) == (jr.nc_pin, jr.nb_pin,
                                                 jr.ez_pin)
    got = pr.render(port_plan(p), pf).image.numpy()
    want = np.asarray(jr.render(p, field).image)
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    ws = j_window_schedule(p, field.bbox_min, field.bbox_max, jitter=None)
    windowed = np.asarray(render_windowed_traced(p, field, ws).image)
    assert np.abs(got - windowed).max() < 1e-5


def test_posed_pin_guards():
    _, _, pr, pf = renderers()
    base = port_plan(_plan(BASE_C2W))
    tiny = p_posed.PosedRenderer(base, pf, nc_pin=pr.nc_pin, nb_pin=1,
                                 ez_pin=pr.ez_pin)
    with pytest.raises(P.DvrenError, match="nb_pin"):
        tiny.render(base, pf)
    # the diagnostics are kept: check_ok raises on them too
    with pytest.raises(P.DvrenError, match="nb_pin"):
        tiny.check_ok()
    # plan-geometry drift raises before any work
    other = _plan(BASE_C2W).descriptor()
    other = port_plan(J.Plan.create(J.PlanConfig(
        width=other.width, height=other.height, t_near=0.25,
        t_far=other.t_far, seed=other.seed, camera=other.camera,
        sampling=other.sampling)))
    with pytest.raises(P.DvrenError, match="base plan"):
        pr.render(other, pf)
    with pytest.raises(P.DvrenError, match="base plan"):
        pr.schedule_for(other)


def test_posed_schedule_structure():
    _, _, pr, _ = renderers()
    sched = pr.schedule_for(port_plan(_plan(ORBIT[0])))
    (g,) = sched.groups
    assert g.n_chunks == pr.nc_pin and g.banks == pr.nb_pin
    hm = sched.hostmap_all.numpy()
    assert hm.min() >= 0 and hm.max() < G ** 3
    lanes = (g.samp[:, :, 2].numpy().astype(np.int32) & 0x7FFF)
    assert lanes.max() < g.banks * 128
    # the one-launch arrays are the group's, and the descriptor the pins'
    tiles = sched.tiles
    assert tiles.shapes == ((g.n_tiles, pr.nc_pin, pr.nb_pin),)
    assert tiles.samp.data_ptr() == g.samp.data_ptr()
    desc = tiles.desc.numpy()
    assert (desc[:, 0] == pr.nc_pin).all() and (desc[:, 1] == pr.nb_pin).all()
    np.testing.assert_array_equal(desc[:, 2], pr.nc_pin * np.arange(
        g.n_tiles))
    assert sched.gather_plan is None and sched.fallback is None


@pytest.mark.parametrize("kind", ["nearest", "clamp", "bfloat16", "sparse"])
def test_render_rechecks_the_field(kind):
    """JAX's render keeps the field without re-running its construction
    checks (render/posed.py:536, 561); the port's render raises."""
    _, field, pr, pf = renderers()
    if kind in ("nearest", "clamp"):
        bad = P.DenseGridField.from_reference_arrays(
            np.asarray(field.sigma), np.asarray(field.color),
            field.bbox_min, field.bbox_max, device="cpu",
            **({"interp": P.InterpMode.NEAREST} if kind == "nearest"
               else {"oob": P.OobPolicy.CLAMP}))
    elif kind == "bfloat16":
        bad = pf.with_packed_dtype("bfloat16")
    else:
        bad = P.SparseGridField.from_dense(pf, threshold=0.0, device="cpu")
    plan = port_plan(_plan(ORBIT[0]))
    with pytest.raises(P.DvrenError):
        pr.render(plan, bad)
    with pytest.raises(P.DvrenError):
        p_posed.PosedRenderer(plan, bad)


def _long_run_scene():
    """Rays along +z through a 2 x 2 x 64 grid with 8 stratified steps of
    0.125 a chunk: a tile's chunk crosses about 60 z-slices."""
    nz = 64
    zs = np.linspace(0, 1, nz)[:, None, None] * np.ones((nz, 2, 2))
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(2, 2, nz),
        sigma=(1.0 + zs).astype(np.float32).reshape(-1),
        color=np.ones((nz, 2, 2, 3), np.float32).reshape(-1)))
    plan = J.Plan.create(J.PlanConfig(
        width=128, height=16, t_near=0.9, t_far=2.1, seed=3,
        camera=J.CameraConfig(k=(2000.0, 0, 64, 0, 2000.0, 8, 0, 0, 1),
                              c2w=BASE_C2W),
        sampling=J.SamplingConfig(dt=0.125, max_steps=16,
                                  mode=J.SamplingMode.STRATIFIED)))
    return plan, field


def test_probe_counts_every_z_slice():
    """JAX's probe stops at 32 slices a run (render/posed.py:327), so it
    undercounts the run lanes of a run that spans more; the port's probe
    counts them all and equals JAX's run statistics at the exact slice
    count."""
    plan, field = _long_run_scene()
    pins = dict(nc_pin=2, nb_pin=4, ez_pin=64)
    jr = JPosed(plan, field, use_kernel=False, **pins)
    k, c2w = jr._cam_arrays(plan)
    j_probe = np.asarray(jax.jit(jr._probe_stats)(k, c2w, jr._consts))
    pr = p_posed.PosedRenderer(port_plan(plan), port_field(field), **pins)
    got = pr._probe_stats(*pr._cam_arrays(port_plan(plan))).numpy()
    ez = int(got[2])
    assert ez > 32 and ez == j_probe[2]

    def exact(k, c2w, consts):
        o, d = jr._tile_rays_planes(k, c2w)
        tke, _ = jr._mask_full(o, d, consts[0])
        lat = jr._window_lattice(o, d, jnp.zeros_like(tke),
                                 plan.sampling.max_steps // 8, consts[0])
        run_lanes = jr._run_stats(*lat[1:], ez=ez)[4]
        cur, _ = jr._pack_offsets(run_lanes)
        return jnp.max(run_lanes), jnp.max(-(-cur // 128))

    run_max, nb_need = (int(v) for v in jax.jit(exact)(k, c2w, jr._consts))
    assert (int(got[1]), int(got[3])) == (run_max, nb_need)
    assert j_probe[1] < run_max              # JAX's probe undercounts


def test_graph_mode_refused_on_the_cpu():
    _, _, pr, pf = renderers()
    base = port_plan(_plan(BASE_C2W))
    with pytest.raises(P.DvrenError, match="CPU"):
        p_posed.PosedRenderer(base, pf, fused=True,
                              nc_pin=pr.nc_pin, nb_pin=pr.nb_pin,
                              ez_pin=pr.ez_pin)
    with pytest.raises(P.DvrenError, match="fused"):
        pr.render_sweep([base], pf)
    assert pr.cache_size() == 0 and pr.captured is None
