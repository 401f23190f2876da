"""Sub-tiled and supercell schedules of dvren_tpu_torch against dvren_tpu,
on the CPU.

Same seeded inputs through both packages, at small sizes:
tests/test_supercell.py::scene (48^2 rays over a 32^3 blob, 32 stratified
steps: 16 px cell tables overflow every tile, the cascade lands on 8 px
supercells) and tests/test_tiled.py::scene (48x32 over 8^3). The JAX side
runs its numpy schedule builder and its reference consumer
(``render_tiled(use_kernel=False)``); its interpreted kernels take minutes
on these scenes, so camera gradients are held to its exact windowed path
(``render_windowed_traced``), the referee of its own supercell camera
test. Held:

- schedules at (tile_px, cell_scale) = (16, 1), (16, 2), (8, 1), (8, 2)
  and (4, 1), gather plans and fallback counts included, equal to
  dvren_tpu's array for array; the cascade's (tile_px, cell_scale, note)
  equal for dense float32, bfloat16 and sparse fields;
- ``build_supercell_stencil`` bit-equal to JAX's, its autograd adjoint
  within 1e-6 x scale of ``jax.vjp``;
- planes of the port's plain path within 5e-6 (depth 1e-4) of JAX's on
  every schedule without overflow, and equal bit for bit across the
  configurations of one scene (the supercell's hat weights and the
  sub-tiles' windows change no per-sample value);
- grid gradients within 2e-6 x scale of ``jax.grad``. On the supercell
  scene the depth head is left out: rays there reach opacity just above
  OPACITY_EPS, where depth = wd / opacity turns last-bit differences into
  1e-3 x scale in both packages' gradients;
- camera gradients within rtol 2e-3 / atol 1e-4;
- K2's twin sums each window's slot rows in sample order
  (``ordered_sums``), equal to a plain loop bit for bit;
- the repairs: an empty schedule renders the background and its backward
  gives zero gradients, as JAX's; the Renderer keys its schedule by the
  field's packed dtype (JAX's key lacks it).

tests/test_torch_cuda.py holds the CUDA kernels' variants to these twins
on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse
from dvren_tpu.ops import grid as j_grid
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from dvren_tpu.render.windowed import build_schedule, render_windowed_traced
from tests.test_supercell import scene as super_scene
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import fused_tiles as p_ft
from dvren_tpu_torch.ops import grid as p_grid
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
GRID_TOL = 2e-6       # x max |reference|
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4
CONFIGS = ((16, 1), (16, 2), (8, 1), (8, 2), (4, 1))


@functools.lru_cache(maxsize=None)
def scene(name):
    """(JAX plan, JAX field, port plan) of one test scene."""
    if name == "super":
        plan, field = super_scene()
    else:
        plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED)
    return plan, field, port_plan(plan)


@functools.lru_cache(maxsize=None)
def schedules(name, px, scale):
    """(JAX numpy schedule, port numpy schedule) at (tile_px, cell_scale),
    both built as cascade probes (no windowed fallback)."""
    plan, field, pplan = scene(name)
    ref = j_tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), tile_px=px,
        cell_scale=scale, device=False, build_fallback=False)
    got = p_tiled.build_tiled_schedule(pplan, port_field(field), tile_px=px,
                                       cell_scale=scale, build_fallback=False)
    return ref, got


def rendered(name):
    """The configurations of a scene whose schedules have no overflow."""
    return [(name, px, s) for px, s in CONFIGS
            if schedules(name, px, s)[0].fallback_rays == 0]


def close(got, ref, tol):
    """|got - ref| <= tol * max |ref|."""
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * scale)


def planes_close(got, ref):
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key).detach().numpy(),
                                   np.asarray(getattr(ref, key)), atol=TOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(got.depth.detach().numpy(),
                               np.asarray(ref.depth), atol=TOL_DEPTH, rtol=0)
    np.testing.assert_array_equal(got.hitmask.numpy(),
                                  np.asarray(ref.hitmask))


def loss_jax(pls, depth):
    loss = (jnp.mean(pls.image ** 2) + 0.1 * jnp.mean(pls.opacity)
            + 0.01 * jnp.mean(pls.transmittance))
    return loss + 0.01 * jnp.mean(pls.depth) if depth else loss


def loss_port(pls, depth):
    loss = (torch.mean(pls.image ** 2) + 0.1 * torch.mean(pls.opacity)
            + 0.01 * torch.mean(pls.transmittance))
    return loss + 0.01 * torch.mean(pls.depth) if depth else loss


# --------------------------------------------------------------- schedules


@pytest.mark.parametrize("px,scale", CONFIGS)
@pytest.mark.parametrize("name", ["super", "tiled"])
def test_schedule_equals_reference(name, px, scale):
    ref, got = schedules(name, px, scale)
    assert_schedules_equal(ref, got)
    gr, gp = ref.gather_plan, got.gather_plan
    assert (gr is None) == (gp is None)
    if gp is not None:
        assert gp.meta == tuple(gr.meta)
        for key in ("all_idx", "inv_map"):
            np.testing.assert_array_equal(getattr(gp, key),
                                          np.asarray(getattr(gr, key)))
    for g in got.groups:
        assert g.bank0.shape == (g.n_tiles, g.n_chunks, (16 // px) ** 2)
        assert g.tile_ids.shape == (g.n_tiles, (16 // px) ** 2)


def test_supercell_scene_overflows_as_expected():
    """The supercell scene is the coarse view the cascade exists for:
    every 16 px cell tile overflows, 8 px supercells hold the frame."""
    assert schedules("super", 16, 1)[1].fallback_rays == 48 * 48
    assert schedules("super", 8, 2)[1].fallback_rays == 0
    assert schedules("super", 8, 2)[1].cell_scale == 2


def _cascade_fields(kind):
    plan, field, pplan = scene("super")
    if kind == "float32":
        return plan, field, pplan, port_field(field)
    if kind == "bfloat16":
        return (plan, field.with_packed_dtype("bfloat16"), pplan,
                port_field(field).with_packed_dtype("bfloat16"))
    return (plan, JSparse.from_dense(field, threshold=0.0), pplan,
            P.SparseGridField.from_dense(port_field(field), threshold=0.0,
                                         device="cpu"))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "sparse"])
def test_cascade_matches_reference(kind):
    plan, jf, pplan, pf = _cascade_fields(kind)
    ref, note = j_tiled.build_tiled_schedule_auto(
        plan, jf, jitter=plan_jitter_table(plan), device=False)
    got, got_note = p_tiled.build_tiled_schedule_auto(pplan, pf)
    assert (got.tile_px, got.cell_scale, got_note) == (
        ref.tile_px, ref.cell_scale, note)
    assert note == ("tiled_supercell_8px" if kind == "float32"
                    else "tiled_subtiled_4px")
    assert_schedules_equal(ref, got)


def test_cascade_keeps_16px_cells_when_they_hold():
    plan, field, pplan = scene("tiled")
    ref, note = j_tiled.build_tiled_schedule_auto(
        plan, field, jitter=plan_jitter_table(plan), device=False)
    got, got_note = p_tiled.build_tiled_schedule_auto(pplan,
                                                      port_field(field))
    assert note is None and got_note is None
    assert (got.tile_px, got.cell_scale) == (16, 1)
    assert_schedules_equal(ref, got)


def test_supercell_checks_match_reference():
    """Supercells need a dense float32 field (the JAX package's checks);
    pitch is forced to 1 there, so pitch 2 does not raise."""
    plan, field, pplan = scene("tiled")
    pf = port_field(field)
    with pytest.raises(P.DvrenError):
        p_tiled.build_tiled_schedule(pplan, pf.with_packed_dtype("bfloat16"),
                                     cell_scale=2)
    with pytest.raises(P.DvrenError):
        p_tiled.build_tiled_schedule(
            pplan, P.SparseGridField.from_dense(pf, device="cpu"),
            cell_scale=2)
    for kwargs in (dict(tile_px=2), dict(cell_scale=3)):
        with pytest.raises(P.DvrenError):
            p_tiled.build_tiled_schedule(pplan, pf, **kwargs)
    got = p_tiled.build_tiled_schedule(pplan, pf, cell_scale=2, pitch=2)
    assert got.pitch == 1
    assert_schedules_equal(schedules("tiled", 16, 2)[0], got)


# --------------------------------------------------------- supercell table


@pytest.mark.parametrize("shape", [(2, 2, 2), (3, 5, 4), (8, 8, 8),
                                   (5, 7, 9)])
def test_supercell_stencil_equals_reference(shape):
    rng = np.random.default_rng(sum(shape))
    sigma = rng.normal(size=shape).astype(np.float32)
    color = rng.normal(size=shape + (3,)).astype(np.float32)
    want = jax.jit(j_grid.build_supercell_stencil)(sigma, color)
    s_t = torch.from_numpy(sigma).requires_grad_(True)
    c_t = torch.from_numpy(color).requires_grad_(True)
    got = p_grid.build_supercell_stencil(s_t, c_t)
    assert got.shape == (p_grid.supercell_rows(shape), 108)
    assert p_grid.supercell_dims(shape) == j_grid.supercell_dims(shape)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    ct = rng.normal(size=tuple(got.shape)).astype(np.float32)
    g_sigma, g_color = torch.autograd.grad(got, (s_t, c_t),
                                           torch.from_numpy(ct))
    w_sigma, w_color = jax.jit(lambda a, b, g: jax.vjp(
        j_grid.build_supercell_stencil, a, b)[1](g))(sigma, color, ct)
    close(g_sigma.numpy(), w_sigma, 1e-6)
    close(g_color.numpy(), w_color, 1e-6)


# ------------------------------------------------------------------ planes


@pytest.mark.parametrize("name,px,scale", rendered("super")
                         + rendered("tiled"))
def test_planes_match_reference(name, px, scale):
    plan, field, pplan = scene(name)
    ref, got = schedules(name, px, scale)
    want = j_tiled.render_tiled(plan, field, ref, use_kernel=False)
    with torch.no_grad():
        out = p_tiled.render_tiled(pplan, port_field(field), got.to("cpu"))
    planes_close(out, want)


@pytest.mark.parametrize("name", ["super", "tiled"])
def test_configurations_render_equal(name):
    """Every configuration without overflow renders the same planes, bit
    for bit: a supercell sample's hat weights are its cell weights and
    its vertices its cell's corners, and the sub-tiles only move its
    window."""
    _, field, pplan = scene(name)
    pf = port_field(field)
    outs = []
    with torch.no_grad():
        for _, px, scale in rendered(name):
            outs.append(p_tiled.render_tiled(
                pplan, pf, schedules(name, px, scale)[1].to("cpu")))
    assert len(outs) >= 2
    for other in outs[1:]:
        for key in ("image", "transmittance", "opacity", "depth"):
            assert torch.equal(getattr(other, key), getattr(outs[0], key))


# --------------------------------------------------------------- gradients


def jax_grid_grads(name, px, scale, depth):
    plan, field, _ = scene(name)
    sched = j_tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), tile_px=px,
        cell_scale=scale, build_fallback=False)

    def loss(params):
        return loss_jax(j_tiled.render_tiled(
            plan, field.with_params(*params), sched, use_kernel=False), depth)

    return jax.jit(jax.grad(loss))((field.sigma, field.color))


@pytest.mark.parametrize("name,px,scale", [("super", 8, 2), ("super", 4, 1),
                                           ("tiled", 4, 1)])
def test_grid_grads_match_jax(name, px, scale):
    _, field, pplan = scene(name)
    depth = name == "tiled"
    pf = port_field(field)
    loss = loss_port(p_tiled.render_tiled(
        pplan, pf, schedules(name, px, scale)[1].to("cpu")), depth)
    got = torch.autograd.grad(loss, (pf.sigma, pf.color))
    for a, b in zip(got, jax_grid_grads(name, px, scale, depth)):
        close(a.numpy(), b, GRID_TOL)


@pytest.mark.parametrize("name,px,scale", [("super", 8, 2), ("tiled", 8, 1)])
def test_camera_grads_match_reference(name, px, scale):
    plan, field, pplan = scene(name)
    wsched = build_schedule(plan, field.bbox_min, field.bbox_max,
                            jitter=plan_jitter_table(plan))
    k0 = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
    c2w0 = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
    dl = np.random.default_rng(7).uniform(
        -1, 1, (plan.height, plan.width, 3)).astype(np.float32)

    def jloss(c2w, k):
        return jnp.sum(render_windowed_traced(plan, field, wsched, k=k,
                                              c2w=c2w).image * dl)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(c2w0, k0)
    c2w, k = (torch.tensor(a, requires_grad=True) for a in (c2w0, k0))
    img = p_tiled.render_tiled(pplan, port_field(field),
                               schedules(name, px, scale)[1].to("cpu"),
                               k=k, c2w=c2w).image
    got = torch.autograd.grad(torch.sum(img * torch.from_numpy(dl)),
                              (c2w, k))
    assert float(got[0].abs().sum()) > 0.0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CAM_RTOL,
                                   atol=CAM_ATOL)


def test_supercell_backward_route():
    """A supercell schedule's backward runs K2 in its supercell form into
    the 108-column table, whose adjoint autograd takes back to the grid;
    no traced gather or scatter node appears."""
    _, field, pplan = scene("super")
    pf = port_field(field)
    before = (p_ft.tile_backward.launches, p_ft.tile_forward.launches)
    loss = loss_port(p_tiled.render_tiled(
        pplan, pf, schedules("super", 8, 2)[1].to("cpu")), False)
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(f for f, _ in node.next_functions)
    names = {type(n).__name__ for n in seen}
    assert "_GroupsetFromTableBackward" in names
    assert "_GroupsetFromParamsBackward" not in names
    bad = {n for n in names if n.startswith(("Index", "Gather", "Scatter",
                                             "Put", "MaskedSelect"))}
    assert not bad, bad
    loss.backward()
    assert float(pf.sigma.grad.abs().max()) > 0.0
    assert (p_ft.tile_backward.launches,
            p_ft.tile_forward.launches) == before   # the CPU runs twins


# ------------------------------------------------------------ K2's order


def test_ordered_sums_add_in_row_order():
    """Each key's rows are added from +0 in their order: equal bit for bit
    to a plain loop, and different from a float64 sum."""
    rng = np.random.default_rng(3)
    n, cols, n_keys = 600, 5, 17
    vals = (rng.normal(size=(n, cols))
            * 10.0 ** rng.integers(-4, 4, (n, 1))).astype(np.float32)
    keys = rng.integers(-1, n_keys, n)
    want = np.zeros((n_keys, cols), np.float32)
    for v, key in zip(vals, keys):
        if key >= 0:
            want[key] = want[key] + v
    got = p_ft.ordered_sums(torch.from_numpy(vals), torch.from_numpy(keys),
                            n_keys)
    np.testing.assert_array_equal(got.numpy(), want)
    assert p_ft.ordered_sums(torch.from_numpy(vals),
                             torch.full((n,), -1), 4).abs().sum() == 0


def test_supercell_grads_equal_cell_grads():
    """The supercell route's grid gradient (K2's 108-column rows through
    the supercell table's adjoint) against the 4 px cell route's (32
    columns through K4's twin), on one scene: within 2e-6 x scale (the
    sums over a vertex's slots run in another order)."""
    _, field, pplan = scene("super")
    grads = []
    for px, scale in ((8, 2), (4, 1)):
        pf = port_field(field)
        loss = loss_port(p_tiled.render_tiled(
            pplan, pf, schedules("super", px, scale)[1].to("cpu")), False)
        grads.append(torch.autograd.grad(loss, (pf.sigma, pf.color)))
    for a, b in zip(*grads):
        close(a.numpy(), b.numpy(), GRID_TOL)


# ------------------------------------------------------------------ repairs


def _outside_scene():
    """tests/test_torch_cuda.py's 48x32 / 8^3 scene with the bbox moved to
    (50, 50, 50)-(51, 51, 51): no ray enters it."""
    plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED,
                              bbox=((50.0, 50.0, 50.0), (51.0, 51.0, 51.0)))
    return plan, field


def test_empty_schedule_matches_reference():
    plan, field = _outside_scene()
    jr = J.Renderer(J.Context.create(), plan,
                    J.RenderOptions(use_tiles=True, capture_stats=False))
    want = jr.forward(field)
    pplan = port_plan(plan)
    pf = port_field(field)
    pr = P.Renderer(P.Context.create(device="cpu"), pplan,
                    P.RenderOptions(use_tiles=True))
    got = pr.forward(pf)
    assert not pr._tiled_schedule.groups
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    dl = np.random.default_rng(3).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    jb = jr.backward(field, dl)
    pb = pr.backward(pf, dl)
    for key in ("sigma", "color", "camera", "camera_k"):
        assert getattr(pb, key).shape == np.asarray(getattr(jb, key)).shape
        assert not np.any(getattr(pb, key))
        assert not np.any(np.asarray(getattr(jb, key)))


def test_empty_schedule_compose_device():
    """The background of an empty schedule is built on the field's
    device (the CPU here; tests/test_torch_cuda.py checks CUDA)."""
    plan, field = _outside_scene()
    pplan, pf = port_plan(plan), port_field(field)
    sched = p_tiled.build_tiled_schedule(pplan, pf).to("cpu")
    assert not sched.groups and sched.gather_plan is None
    planes = p_tiled.render_tiled(pplan, pf, sched)
    assert planes.image.device == pf.sigma.device
    assert torch.all(planes.transmittance == 1.0)


def test_renderer_keys_schedule_by_packed_dtype():
    """A float32 field, then a bfloat16 field of the same shape and bbox:
    the cascade gives supercells to the first and cells to the second, so
    the second must not reuse the first's schedule."""
    plan, field, pplan = scene("super")
    pf = port_field(field)
    r = P.Renderer(P.Context.create(device="cpu"), pplan,
                   P.RenderOptions(use_tiles=True))
    first = r.forward(pf)
    assert "tiled_supercell_8px" in first.stats.notes
    assert r._tiled_schedule.cell_scale == 2
    half = r.forward(pf.with_packed_dtype("bfloat16"))
    assert "tiled_subtiled_4px" in half.stats.notes
    assert (r._tiled_schedule.tile_px, r._tiled_schedule.cell_scale) == (4, 1)
    np.testing.assert_allclose(half.image, first.image, atol=5e-3)
    again = r.forward(pf)
    assert r._tiled_schedule.cell_scale == 2
    np.testing.assert_array_equal(again.image, first.image)
