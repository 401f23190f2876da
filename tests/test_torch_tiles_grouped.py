"""The dense tile path's one-launch route: every tile group of a schedule
through one K1 and one K2 call, from the schedule's flat arrays and
per-tile descriptor (``fused_tiles.TileSet``, ``TiledSchedule.tiles``), on
the CPU; and the two repairs of the grid path's schedule.

Scenes: tests/test_tiled.py::scene (48x32 rays over an 8^3 grid,
stratified) at 16 px cells, 8 px supercells, 8 and 4 px cells, as sparse
bricks, with a bfloat16 table, and two views merged into one schedule.
Held:

- the flat arrays equal the groups' arrays concatenated, the descriptor
  indexes each group's slices and the launch order takes every tile once,
  the most chunks first; the groups' arrays are views of
  the flat ones, as numpy arrays and after ``.to``;
- the set-wide twins (``tile_forward_set_plain``,
  ``tile_backward_set_plain``) equal the one-group twins called group by
  group, bit for bit: K1's heads, K2's slot rows, its bank form and
  d(rayt); the wrappers run them on the CPU, and refuse bad descriptors
  and shapes;
- ``render_tiled`` through the flat route, its grid gradients and its
  camera gradients against JAX's ``render_tiled`` (its reference
  consumer: no kernel is interpreted): planes 5e-6, depth 1e-4, grids
  2e-6 x scale, camera rtol 2e-3 / atol 1e-4; repeats bit for bit;
- the grid path: an explicit ``tile_px`` that overflows keeps no windowed
  fallback, as JAX's schedule does, and ``render_hash_grid_tiled``
  renders a zero-overflow schedule that ``build_tiled_schedule`` built
  over the finest lattice, equal to JAX's ``render_hash_grid_tiled``.

Each JAX reference is jitted and computed once per case.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests.test_tiled import scene
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import fused_tiles as p_ft
from dvren_tpu_torch.ops import hash_grid as p_hg
from dvren_tpu_torch.ops import packed_transpose as p_pt
from dvren_tpu_torch.ops.grid import build_supercell_stencil
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.render import hash_tiled as p_hash
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
GRID_TOL = 2e-6      # x max |reference|
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4
FLAT = ("samp", "base", "rayt", "k_enter", "bank0")
# case -> (tile_px, cell_scale, table: "f32" | "bf16" | "sparse", views)
CASES = {
    "cell": (16, 1, "f32", 1),
    "super": (8, 2, "f32", 1),
    "subs4": (8, 1, "f32", 1),
    "subs16": (4, 1, "f32", 1),
    "sparse": (16, 1, "sparse", 1),
    "bf16": (16, 1, "bf16", 1),
    "merged": (16, 1, "f32", 2),
}
VIEW_C2WS = tuple((1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0, 1, -1.0)
                  for dx in (0.0, 0.1))


def jax_scene():
    return scene(mode=J.SamplingMode.STRATIFIED)


def port_fields(name):
    """(port plan, port field) of a case; the field in its table form."""
    plan, field = jax_scene()
    pplan, pfield = port_plan(plan), port_field(field)
    kind = CASES[name][2]
    if kind == "sparse":
        pfield = P.SparseGridField.from_dense(pfield, threshold=0.0,
                                              device="cpu")
    elif kind == "bf16":
        pfield = pfield.with_packed_dtype("bfloat16")
    return pplan, pfield


def view_plans(pplan):
    """The two views of tests/test_tiled.py:479-480 (port plans)."""
    return p_fit.view_plans(pplan, [P.CameraConfig(c2w=c)
                                    for c in VIEW_C2WS])


@functools.lru_cache(maxsize=None)
def host_schedule(name):
    """The case's numpy schedule (a merged schedule's ``.sched``) and, for
    the merged case, the MergedViewSchedule."""
    px, scale, _, views = CASES[name]
    pplan, pfield = port_fields(name)
    if views == 1:
        return p_tiled.build_tiled_schedule(pplan, pfield, tile_px=px,
                                            cell_scale=scale), None
    plans = view_plans(pplan)
    merged = p_tiled.merge_view_schedules(
        [p_tiled.build_tiled_schedule(p, pfield, tile_px=px, quantize=True)
         for p in plans], plans=plans)
    return merged.sched, merged


@functools.lru_cache(maxsize=None)
def cpu_schedule(name):
    return host_schedule(name)[0].to("cpu")


def table_of(name):
    """The (R, C) table the case's bank gather reads."""
    pplan, pfield = port_fields(name)
    if CASES[name][2] == "sparse":
        return pfield.bricks.detach().reshape(-1, 32)
    if CASES[name][1] == 2:
        return build_supercell_stencil(pfield.sigma.detach(),
                                       pfield.color.detach())
    if CASES[name][2] == "bf16":
        return p_pt.build_rows16_plain(pfield.sigma.detach(),
                                       pfield.color.detach(), torch.bfloat16)
    return p_pt.build_rows_plain(pfield.sigma.detach(), pfield.color.detach())


def set_args(name):
    """(flat bank tables, tile set, TileParams) of the case's schedule."""
    pplan, _ = port_fields(name)
    sched = cpu_schedule(name)
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    stencil = "super" if sched.cell_scale == 2 else "cell"
    tabs = p_tiled._gather_banks_flat(table_of(name), sched.gathermap_all)
    return tabs, sched.tiles, p_ft.tiles_op_params(pplan, geom, sched.tiles,
                                                   stencil)


def test_cases_have_several_groups():
    for name in CASES:
        sched = cpu_schedule(name)
        assert len(sched.groups) > 1, name
        assert sched.tiled_samples > 0 and sched.fallback_rays == 0, name
    assert cpu_schedule("super").tiles.subs == 4
    assert cpu_schedule("subs16").tiles.subs == 16
    assert cpu_schedule("sparse").table_kind == "sparse"


@pytest.mark.parametrize("name", sorted(CASES))
def test_flat_arrays_and_descriptor_index_the_groups(name):
    sched = cpu_schedule(name)
    tiles = sched.tiles
    subs = sched.subs
    assert tiles.subs == subs
    assert tiles.shapes == tuple((g.n_tiles, g.n_chunks, g.banks)
                                 for g in sched.groups)
    for key, flat in (("samp", tiles.samp), ("base", tiles.base),
                      ("rayt", tiles.rayt), ("k_enter", tiles.ke),
                      ("bank0", tiles.bank0)):
        cat = torch.cat([getattr(g, key).reshape((-1,) + tuple(
            flat.shape[1:])) for g in sched.groups])
        assert cat.dtype == flat.dtype and torch.equal(cat, flat), key
    desc = tiles.desc.numpy()
    assert desc.dtype == np.int32 and desc.shape == (tiles.n_tiles, 4)
    t0 = c0 = b0 = 0
    for g in sched.groups:
        n, nc, nb = g.n_tiles, g.n_chunks, g.banks
        d = desc[t0:t0 + n]
        np.testing.assert_array_equal(d[:, :2], [[nc, nb]] * n)
        np.testing.assert_array_equal(d[:, 2], c0 + nc * np.arange(n))
        np.testing.assert_array_equal(d[:, 3], b0 + nb * np.arange(n))
        for j in (0, n - 1):
            ch, bk = int(d[j, 2]), int(d[j, 3])
            assert torch.equal(tiles.samp[ch:ch + nc], g.samp[j])
            assert torch.equal(tiles.base[bk:bk + nb], g.base[j])
            assert torch.equal(tiles.bank0[ch * subs:(ch + nc) * subs],
                               g.bank0[j].reshape(-1))
        t0, c0, b0 = t0 + n, c0 + n * nc, b0 + n * nb
    assert (t0, c0, b0) == (tiles.n_tiles, tiles.n_chunk_rows,
                            tiles.n_bank_rows)
    # the launch order: every tile once, by falling chunk count, stable
    order = tiles.order.numpy()
    assert order.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(tiles.n_tiles))
    np.testing.assert_array_equal(order, np.argsort(-desc[:, 0],
                                                    kind="stable"))
    assert b0 * 128 == int(sched.gathermap_all.shape[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_groups_are_views_before_and_after_to(name):
    host = host_schedule(name)[0]
    assert isinstance(host.tiles.samp, np.ndarray)
    for g in host.groups:
        for key, flat in zip(FLAT, (host.tiles.samp, host.tiles.base,
                                    host.tiles.rayt, host.tiles.ke,
                                    host.tiles.bank0)):
            assert np.shares_memory(getattr(g, key), flat), key
    moved = cpu_schedule(name)
    assert moved.tiles.device == torch.device("cpu")
    assert torch.equal(moved.tiles.desc, torch.from_numpy(host.tiles.desc))
    for g, h in zip(moved.groups, host.groups):
        for key, flat in zip(FLAT, (moved.tiles.samp, moved.tiles.base,
                                    moved.tiles.rayt, moved.tiles.ke,
                                    moved.tiles.bank0)):
            assert (getattr(g, key).untyped_storage().data_ptr()
                    == flat.untyped_storage().data_ptr()), key
            np.testing.assert_array_equal(getattr(g, key).numpy(),
                                          getattr(h, key))


def test_a_schedule_without_tiles_moves_with_them():
    """A schedule whose flat arrays were taken away gets them back from
    its groups: ``.to`` and ``tile_set`` build the same arrays."""
    host = host_schedule("subs4")[0]
    bare = dataclasses.replace(host, tiles=None)
    for key in ("samp", "base", "rayt", "ke", "bank0", "desc", "order"):
        np.testing.assert_array_equal(getattr(bare.tile_set(), key),
                                      getattr(host.tiles, key), err_msg=key)
    moved = bare.to("cpu")
    for key in ("samp", "base", "rayt", "ke", "bank0", "desc", "order"):
        assert torch.equal(getattr(moved.tiles, key),
                           getattr(cpu_schedule("subs4").tiles, key)), key


def per_group(name):
    """Per group the one-group twins' arguments and TileParams."""
    tabs, tiles, prm = set_args(name)
    return [(views, dataclasses.replace(prm, n_chunks=nc, banks=nb))
            for views, (_, nc, nb) in zip(tiles.group_views(tabs),
                                          tiles.shapes)]


def cotangent(tiles, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(tiles.n_tiles, 5, 16, 16)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_set_twins_equal_group_twins(name):
    tabs, tiles, prm = set_args(name)
    gs = cotangent(tiles)
    rayt = tiles.rayt + 0.0
    k1 = p_ft.tile_forward_set_plain(tabs, tiles, prm)
    rows, d_rayt = p_ft.tile_backward_set_plain(tabs, tiles, gs, prm,
                                                cam=True, rayt=rayt)
    cell = prm.stencil == "cell"
    if cell:
        banks, _ = p_ft.tile_backward_set_plain(tabs, tiles, gs, prm,
                                                emit="banks")
        assert torch.equal(banks, rows.transpose(1, 2))
    assert k1.shape == (tiles.n_tiles, 5, 16, 16)
    assert rows.shape == (tiles.n_bank_rows, 128, prm.cols)
    assert d_rayt.shape == (tiles.n_tiles, 12, 128)
    t0 = b0 = 0
    for views, p in per_group(name):
        n = int(views[0].shape[0])
        nb = p.banks
        assert torch.equal(k1[t0:t0 + n], p_ft.tile_forward_plain(*views, p))
        g_rows, g_rayt = p_ft.tile_backward_plain(
            *views, gs[t0:t0 + n].contiguous(), p, cam=True)
        assert torch.equal(rows[b0:b0 + n * nb],
                           g_rows.reshape(-1, 128, prm.cols))
        assert torch.equal(d_rayt[t0:t0 + n], g_rayt)
        if cell:
            g_banks, _ = p_ft.tile_backward_plain(
                *views, gs[t0:t0 + n].contiguous(), p, emit="banks")
            assert torch.equal(banks[b0:b0 + n * nb],
                               g_banks.reshape(-1, 32, 128))
        t0, b0 = t0 + n, b0 + n * nb
    assert float(rows.abs().max()) > 0.0 and float(k1[:, 4].max()) > 0.0


@pytest.mark.parametrize("name", ["cell", "super", "subs16"])
def test_wrappers_on_cpu_run_the_set_twins(name):
    tabs, tiles, prm = set_args(name)
    gs = cotangent(tiles, seed=4)
    before = (p_ft.tile_forward.launches, p_ft.tile_backward.launches)
    out = p_ft.tile_forward(tabs, tiles, prm)
    rows, d_rayt = p_ft.tile_backward(tabs, tiles, gs, prm, cam=True)
    assert (p_ft.tile_forward.launches,
            p_ft.tile_backward.launches) == before   # the CPU runs twins
    assert torch.equal(out, p_ft.tile_forward_set_plain(tabs, tiles, prm))
    want = p_ft.tile_backward_set_plain(tabs, tiles, gs, prm, cam=True)
    assert torch.equal(rows, want[0]) and torch.equal(d_rayt, want[1])
    again = p_ft.tile_backward(tabs, tiles, gs, prm, cam=True)
    assert torch.equal(again[0], rows) and torch.equal(again[1], d_rayt)


def test_bad_descriptors_and_shapes_are_refused():
    tabs, tiles, prm = set_args("subs4")
    gs = cotangent(tiles)
    with pytest.raises(TypeError, match="desc"):
        p_ft.tile_forward(tabs, dataclasses.replace(
            tiles, desc=tiles.desc.long()), prm)
    with pytest.raises(ValueError, match="desc"):
        p_ft.tile_forward(tabs, dataclasses.replace(
            tiles, desc=tiles.desc[1:]), prm)
    with pytest.raises(ValueError, match="tabs"):
        p_ft.tile_forward(tabs[1:], tiles, prm)
    with pytest.raises(ValueError, match="subs"):
        p_ft.tile_forward(tabs, tiles, dataclasses.replace(prm, subs=16))
    with pytest.raises(ValueError, match="rayt"):
        p_ft.tile_forward(tabs, tiles, prm, rayt=tiles.rayt[1:])
    with pytest.raises(ValueError, match="gs"):
        p_ft.tile_backward(tabs, tiles, gs[1:], prm)
    with pytest.raises(ValueError, match="emit"):
        p_ft.tile_backward(tabs, tiles, gs, prm, emit="u16")
    with pytest.raises(TypeError, match="tensor"):
        p_ft.tile_forward(tabs, host_schedule("subs4")[0].tiles, prm)


# --------------------------------------------- the route against JAX

ROUTE_CASES = ("cell", "super", "subs4", "subs16", "sparse")


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """JAX's render_tiled on its own schedule of the case: planes, and the
    gradients of a seeded loss in the grid (or the bricks) through its
    reference consumer, jitted; at 16 px cells also in c2w / k, which
    JAX differentiates through its kernel only (interpreted at subs 1)."""
    px, scale, kind, _ = CASES[name]
    plan, field = jax_scene()
    if kind == "sparse":
        from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse

        field = JSparse.from_dense(field, threshold=0.0)
    sched = j_tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), tile_px=px,
        cell_scale=scale, device=False)
    dl = dl_image(plan)
    params = ((field.bricks,) if kind == "sparse"
              else (field.sigma, field.color))

    def loss(*p):
        img = j_tiled.render_tiled(plan, field.with_params(*p), sched,
                                   use_kernel=False).image
        return jnp.sum(img * dl)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(params)))))(
        *params)
    cam = None
    if name == "cell":
        def cam_loss(c2w, k):
            img = j_tiled.render_tiled(plan, field, sched, k=k,
                                       c2w=c2w).image
            return jnp.sum(img * dl)

        k0 = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
        c2w0 = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
        cam = [np.asarray(g) for g in jax.jit(jax.grad(
            cam_loss, argnums=(0, 1)))(c2w0, k0)]
    planes = j_tiled.render_tiled(plan, field, sched, use_kernel=False)
    return planes, [np.asarray(g) for g in grads], cam


def dl_image(plan):
    return np.random.default_rng(7).uniform(
        -1, 1, (plan.height, plan.width, 3)).astype(np.float32)


def port_route(name, cam: bool):
    """The port's frame and gradients through the one-launch route: (grid
    or bricks) and with ``cam`` (c2w, k) too."""
    pplan, pfield = port_fields(name)
    sched = cpu_schedule(name)
    with torch.no_grad():
        planes = p_tiled.render_tiled(pplan, pfield, sched)
    if hasattr(pfield, "bricks"):
        leaf = pfield.with_params(pfield.bricks.detach().clone())
        params = (leaf.bricks,)
    else:
        leaf = pfield.with_params(pfield.sigma.detach().clone(),
                                  pfield.color.detach().clone())
        params = (leaf.sigma, leaf.color)
    kw = {}
    if cam:
        kw = {"k": torch.tensor(pplan.camera.k, dtype=torch.float32)
              .reshape(3, 3).requires_grad_(True),
              "c2w": torch.tensor(pplan.camera.c2w, dtype=torch.float32)
              .reshape(3, 4).requires_grad_(True)}
        params = params + (kw["c2w"], kw["k"])
    img = p_tiled.render_tiled(pplan, leaf, sched, **kw).image
    grads = torch.autograd.grad(
        torch.sum(img * torch.from_numpy(dl_image(pplan))), params)
    return planes, grads


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_route_matches_jax_render_tiled(name):
    want, g_want, cam_want = jax_reference(name)
    got, g_got = port_route(name, cam=cam_want is not None)
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)), atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=TOL_DEPTH)
    assert float(got.opacity.max()) > 0.0
    for a, b in zip(g_got, g_want):
        scale = float(np.abs(b).max())
        assert scale > 0.0
        err = float(np.abs(a.numpy().reshape(b.shape) - b).max())
        assert err <= GRID_TOL * scale, (err, scale)
    if cam_want is not None:
        for a, b in zip(g_got[len(g_want):], cam_want):
            assert float(np.abs(b).max()) > 0.0
            np.testing.assert_allclose(a.numpy(), b, rtol=CAM_RTOL,
                                       atol=CAM_ATOL)


@pytest.mark.parametrize("name", ["cell", "super"])
def test_route_repeats_bit_for_bit(name):
    a, ga = port_route(name, cam=True)
    b, gb = port_route(name, cam=True)
    for key in ("image", "transmittance", "opacity", "depth"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


def test_merged_stack_equals_per_view_frames():
    """The merged two-view schedule through render_tiled_stack (one K1
    launch over its groups) equals each view's own schedule rendered
    alone, bit for bit."""
    pplan, pfield = port_fields("merged")
    merged = host_schedule("merged")[1].to("cpu")
    with torch.no_grad():
        stack = p_tiled.render_tiled_stack(pplan, pfield, merged)
        for v, pv in enumerate(view_plans(pplan)):
            own = p_tiled.build_tiled_schedule(pv, pfield,
                                               quantize=True).to("cpu")
            img = p_tiled.render_tiled(pv, pfield, own).image
            assert torch.equal(stack[v], img), v


# ------------------------------------------ the grid path's schedule


def test_grid_schedule_at_an_overflowing_tile_px_has_no_fallback():
    """An explicit 16 px over a scene that overflows it: the port's grid
    schedule keeps the overflow count and no windowed fallback, as JAX's
    ``build_hash_grid_schedule`` does (``build_fallback=False``)."""
    from tests import test_torch_grid_subtiles as gs_tests

    name = next(n for n in gs_tests.SCENES
                if gs_tests.j_schedule(n, 16).fallback_rays > 0)
    ref = gs_tests.j_schedule(name, 16)
    got = gs_tests.p_schedule(name, 16)
    assert ref.fallback is None
    assert got.fallback is None and got.fallback_rays == ref.fallback_rays


def test_grid_render_takes_the_dense_schedulers_schedule():
    """``render_hash_grid_tiled`` renders a zero-overflow schedule that
    ``tiled.build_tiled_schedule`` built over the finest lattice (not
    ``build_hash_grid_schedule``), within 5e-6 (depth 1e-4) of JAX's
    ``render_hash_grid_tiled`` on its own grid schedule."""
    from tests import test_torch_hash_grid as hg_tests

    _, _, pplan, pf = hg_tests.case("fixed")
    proxy = p_hash._HashSchedProxy(
        schedule_grid_shape=p_hg.grid_shape(pf.spec))
    own = p_tiled.build_tiled_schedule(pplan, proxy).to("cpu")
    assert own.fallback_rays == 0 and own.fallback is None
    with torch.no_grad():
        got = p_hash.render_hash_grid_tiled(pplan, pf, own)
    want = hg_tests.j_forward("fixed")
    for key in ("image", "opacity", "transmittance"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)), atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=TOL_DEPTH)
    assert float(got.opacity.max()) > 0.0
