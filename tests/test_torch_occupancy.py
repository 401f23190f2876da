"""Occupancy trimming of the tile schedule, against dvren_tpu.

``build_tiled_schedule(occupancy=True)`` trims each ray's step window to
its first..last sample in a non-empty cell (all 8 corner sigmas exactly
zero elsewhere). On a 16^3 SDF shell (``tests/test_native.py``'s field)
and on a sparse field of it: the empty-cell masks, the trimmed windows
(native and numpy) and the schedules equal the JAX package's; the frame
equals the untrimmed frame within 5e-6; the backward is the gradient of
the trimmed render, held to ``jax.grad`` of JAX's trimmed render at 2e-6
x scale (on a solid ball). ``RenderOptions(use_occupancy=True)`` rebuilds the schedule when
an in-place edit of ``field.sigma`` empties or fills a cell.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render import windowed as j_windowed
from dvren_tpu.render.pipeline import plan_jitter_table
from dvren_tpu.render.windowed import build_schedule, render_windowed_traced
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.ops.raygen import camera_arrays
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
GRID_TOL = 2e-6
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4
MODES = {"fixed": J.SamplingMode.FIXED,
         "stratified": J.SamplingMode.STRATIFIED}


def shell_field(n=16, ball=False):
    """An SDF shell: sigma 20 where |r - 0.33| < 0.08 (``ball``: r <
    0.41), exact zeros elsewhere; seeded random colour."""
    rng = np.random.default_rng(5)
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r = np.sqrt((xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.5) ** 2)
    inside = r < 0.41 if ball else np.abs(r - 0.33) < 0.08
    sigma = np.where(inside, 20.0, 0.0).astype(np.float32)
    color = rng.uniform(0, 1, (n, n, n, 3)).astype(np.float32)
    return J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.reshape(-1),
        color=color.reshape(-1)))


@functools.lru_cache(maxsize=None)
def case(mode, kind="dense"):
    """(JAX plan, JAX field, port plan, port field)."""
    plan, _ = tiled_scene(mode=MODES[mode])
    field = shell_field()
    if kind == "sparse":
        field = JSparse.from_dense(field, threshold=0.0)
        pfield = P.SparseGridField.from_reference(
            np.asarray(field.bricks), np.asarray(field.occupancy),
            field.grid_shape, field.bbox_min, field.bbox_max, device="cpu")
    else:
        pfield = port_field(field)
    return plan, field, port_plan(plan), pfield


def test_empty_cells_equal_reference():
    _, field, _, pfield = case("fixed")
    want = j_tiled._empty_cells(field.sigma)
    got = p_tiled._empty_cells(pfield.sigma)
    assert 0 < int(got.sum()) < got.size
    np.testing.assert_array_equal(got, want)


def test_empty_cells_sparse_equal_reference():
    _, js, _, ps = case("fixed", "sparse")
    want = j_tiled._empty_cells_sparse(js)
    got = p_tiled._empty_cells_sparse(ps)
    assert 0 < int(got.sum()) < got.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("core", ["native", "numpy"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_trimmed_windows_equal_reference(mode, core, monkeypatch):
    monkeypatch.setenv("DVREN_NATIVE_SCHED", "1" if core == "native" else "0")
    plan, field, pplan, pfield = case(mode)
    bbox = (tuple(float(v) for v in field.bbox_min),
            tuple(float(v) for v in field.bbox_max))
    o, d = j_windowed._host_rays(plan)
    ke, cnt = j_windowed._windows(plan, *bbox)
    jitter = plan_jitter_table(plan)
    want = j_tiled._tighten_windows_by_occupancy(
        plan, o, d, ke.astype(np.int64), cnt.astype(np.int64), jitter,
        *bbox, (16, 16, 16), j_tiled._empty_cells(field.sigma))
    got = p_tiled._tighten_windows_by_occupancy(
        pplan, o, d, ke.astype(np.int64), cnt.astype(np.int64), jitter,
        *bbox, (16, 16, 16), p_tiled._empty_cells(pfield.sigma))
    assert int(got[1].sum()) < int(cnt.sum())
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,mode,px", [("dense", "fixed", 16),
                                          ("dense", "stratified", 8),
                                          ("sparse", "stratified", 16)])
def test_schedule_equals_reference(kind, mode, px):
    plan, field, pplan, pfield = case(mode, kind)
    ref = j_tiled.build_tiled_schedule(plan, field, device=False,
                                       jitter=plan_jitter_table(plan),
                                       tile_px=px, occupancy=True)
    got = p_tiled.build_tiled_schedule(pplan, pfield, tile_px=px,
                                       occupancy=True)
    full = p_tiled.build_tiled_schedule(pplan, pfield, tile_px=px)
    assert got.tiled_samples < full.tiled_samples
    assert_schedules_equal(ref, got)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_trimmed_frame_equals_untrimmed(kind):
    _, _, pplan, pfield = case("stratified", kind)
    with torch.no_grad():
        a = p_tiled.render_tiled(pplan, pfield, p_tiled.build_tiled_schedule(
            pplan, pfield, occupancy=True).to("cpu"))
        b = p_tiled.render_tiled(pplan, pfield, p_tiled.build_tiled_schedule(
            pplan, pfield).to("cpu"))
    assert float(b.opacity.max()) > 0.1
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(a, key).numpy(),
                                   getattr(b, key).numpy(), atol=TOL, rtol=0,
                                   err_msg=key)


def test_trimmed_backward_matches_jax():
    """The gradient of the trimmed render against ``jax.grad`` of JAX's
    trimmed render (its reference consumer, on its ``occupancy=True``
    schedule), grid at 2e-6 x scale, on a solid ball (exact zeros around
    it), sigma where it is nonzero (JAX's consumer takes the other tie at
    exact-zero sigma, ROADMAP Queue 3); camera gradients, which
    the trimmed steps do not touch (every corner of their cells is zero),
    against JAX's windowed path at rtol 2e-3 / atol 1e-4."""
    plan, _, pplan, _ = case("stratified")
    field = shell_field(ball=True)
    jsched = j_tiled.build_tiled_schedule(plan, field, occupancy=True,
                                          jitter=plan_jitter_table(plan))

    def loss(params):
        pls = j_tiled.render_tiled(plan, field.with_params(*params), jsched,
                                   use_kernel=False)
        return jnp.mean(pls.image ** 2) + 0.1 * jnp.mean(pls.opacity)

    want = jax.jit(jax.grad(loss))((field.sigma, field.color))
    pf = port_field(field)
    psched = p_tiled.build_tiled_schedule(pplan, pf, occupancy=True)
    assert psched.tiled_samples < p_tiled.build_tiled_schedule(
        pplan, pf).tiled_samples
    pls = p_tiled.render_tiled(pplan, pf, psched.to("cpu"))
    got = torch.autograd.grad(torch.mean(pls.image ** 2)
                              + 0.1 * torch.mean(pls.opacity),
                              (pf.sigma, pf.color))
    # a voxel of sigma 0 takes the tie at every sample it weighs (the
    # sample's sigma is 0 where the cell's other corners weigh nothing):
    # compared where sigma > 0, and the colour everywhere
    live = np.asarray(field.sigma) > 0
    for a, b, where in zip(got, want, (live, np.ones_like(live))):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0
        np.testing.assert_allclose(a.numpy()[where], b[where], rtol=0,
                                   atol=GRID_TOL * scale)

    wsched = build_schedule(plan, field.bbox_min, field.bbox_max,
                            jitter=plan_jitter_table(plan))
    k0 = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
    c2w0 = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
    dl = np.random.default_rng(7).uniform(
        -1, 1, (plan.height, plan.width, 3)).astype(np.float32)

    def jloss(c2w, k):
        return jnp.sum(render_windowed_traced(plan, field, wsched, k=k,
                                              c2w=c2w).image * dl)

    cam_want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(c2w0, k0)
    c2w, k = (torch.tensor(a, requires_grad=True) for a in (c2w0, k0))
    img = p_tiled.render_tiled(pplan, pf, psched.to("cpu"), k=k,
                               c2w=c2w).image
    cam = torch.autograd.grad(torch.sum(img * torch.from_numpy(dl)),
                              (c2w, k))
    for a, b in zip(cam, cam_want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CAM_RTOL,
                                   atol=CAM_ATOL)


def _renderer(pplan):
    return P.Renderer(P.Context.create(device="cpu"), pplan,
                      P.RenderOptions(use_tiles=True, use_occupancy=True))


@pytest.mark.parametrize("edit", ["empty", "fill"])
def test_renderer_rebuilds_when_the_zero_set_changes(edit):
    """An in-place edit of ``field.sigma.data`` that empties cells (or
    fills empty ones) keeps the tensor object, and ``.data`` edits keep
    its version counter: the Renderer's frame after it equals a fresh
    Renderer's, whose schedule is built for the new zero set."""
    _, field, pplan, _ = case("stratified")
    pf = port_field(field)
    r = _renderer(pplan)
    before = r.forward(pf)
    sigma = pf.sigma.data
    if edit == "empty":
        sigma[:, :, 8:] = 0.0
    else:
        sigma[6:10, 6:10, 6:10] = 30.0      # the shell's empty inside
    again = r.forward(pf)
    fresh = _renderer(pplan).forward(pf)
    np.testing.assert_array_equal(again.image, fresh.image)
    np.testing.assert_array_equal(again.depth, fresh.depth)
    assert float(np.abs(again.image - before.image).max()) > 1e-3
    # the same zero set: no rebuild, the same schedule object
    sched = r._tiled_schedule
    sigma.mul_(1.5)
    r.forward(pf)
    assert r._tiled_schedule is sched


def test_renderer_occupancy_sparse_frame_and_backward():
    """A sparse shell through ``use_occupancy``: the untrimmed frame
    within 5e-6, and the backward is the trimmed render's (the bricks'
    gradient of ``render_tiled`` on the Renderer's schedule)."""
    plan, _, pplan, ps = case("stratified", "sparse")
    r = _renderer(pplan)
    got = r.forward(ps)
    ref = P.Renderer(P.Context.create(device="cpu"), pplan,
                     P.RenderOptions(use_tiles=True)).forward(ps)
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL, rtol=0, err_msg=key)
    dl = np.random.default_rng(2).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    g = r.backward(ps, dl)
    leaf = ps.with_params(ps.bricks.detach().clone().requires_grad_(True))
    k, c2w, _ = camera_arrays(pplan, torch.device("cpu"))
    img = p_tiled.render_tiled(pplan, leaf, r._tiled_schedule, k=k,
                               c2w=c2w).image
    dl_img = torch.from_numpy(dl.reshape(plan.height, plan.width, 3))
    want = torch.autograd.grad(torch.sum(img * dl_img), leaf.bricks)[0]
    assert float(want.abs().max()) > 0
    np.testing.assert_array_equal(g.bricks, want.numpy())
