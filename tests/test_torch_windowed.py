"""The windowed path and the dense-lattice pipeline of dvren_tpu_torch
against dvren_tpu, on the CPU.

Same seeded inputs through both packages, on tests/test_windowed.py's
scene (24x18 rays over an 8^3 grid in a sub-box, 60 steps; fixed and
stratified, an ROI, an orthographic camera, a nearest field) and three
orbiting views of it. The JAX side runs its jnp paths
(``render_windowed``, ``pipeline.render``, ``render_streamed``,
``render_windowed_stack`` and ``jax.grad`` of them). Held:

- windowed and stack schedules equal to JAX's array for array;
- planes within 5e-6 (depth 1e-4), the hitmask equal; window == full
  within 1e-5 (depth 1e-4); the stack within 5e-6 of the per-view
  renders;
- grid gradients within rtol 1e-4 / atol 1e-8 (tests/test_windowed.py's
  bound), ``Renderer.backward``'s (a cotangent of mixed sign, whose sums
  cancel) within 2e-6 x scale (tests/test_fused_tiles.py's), camera
  gradients within rtol 2e-3 / atol 1e-4;
- sampling, point evaluation (nearest / trilinear, zero / clamp, the
  packed stencil in float32 and bfloat16, sparse bricks) and the compose
  against JAX's;
- ``Renderer(use_window=True)`` forward and backward against JAX's;
- ``generate_rays(plan)`` and ``roi_hitmask(plan)`` default to the card
  (raising where torch has no CUDA, as ``Context`` does).

tests/test_torch_cuda.py runs the windowed path on the card.
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse
from dvren_tpu.ops import grid as j_grid
from dvren_tpu.ops import sampling as j_sampling
from dvren_tpu.ops.raygen import generate_rays as j_generate_rays
from dvren_tpu.opt.fit import view_plans as j_view_plans
from dvren_tpu.render import pipeline as j_pipe
from dvren_tpu.render import windowed as j_win
from tests.test_torch_core import port_field, port_plan
from tests.test_windowed import scene as windowed_scene

import dvren_tpu_torch as P
from dvren_tpu_torch.core.status import DvrenError
from dvren_tpu_torch.ops import compose as p_compose
from dvren_tpu_torch.ops import grid as p_grid
from dvren_tpu_torch.ops import sampling as p_sampling
from dvren_tpu_torch.ops.raygen import camera_arrays, generate_rays
from dvren_tpu_torch.render import pipeline as p_pipe
from dvren_tpu_torch.render import windowed as p_win

# dvren_tpu.ops re-exports a function named ``compose``: take the module
j_compose = importlib.import_module("dvren_tpu.ops.compose")

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
G_RTOL, G_ATOL = 1e-4, 1e-8
GRID_TOL = 2e-6     # x max |reference|: Renderer.backward's sums
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4


def scene(name):
    """(JAX plan, JAX field) of a named variant of the windowed scene."""
    if name == "stratified":
        return windowed_scene(mode=J.SamplingMode.STRATIFIED)
    if name in ("fixed", "nearest"):
        plan, field = windowed_scene()
        if name == "nearest":
            field = field.__class__(
                sigma=field.sigma, color=field.color,
                bbox_min=field.bbox_min, bbox_max=field.bbox_max,
                interp=J.InterpMode.NEAREST)
        return plan, field
    rng = np.random.default_rng(5 if name == "roi" else 6)
    n = 8
    if name == "roi":
        plan = J.Plan.create(J.PlanConfig(
            width=24, height=18, t_near=0.1, t_far=3.1, seed=2,
            roi=J.Roi(x=5, y=3, width=12, height=9),
            camera=J.CameraConfig(
                k=(30.0, 0, 12.0, 0, 30.0, 9.0, 0, 0, 1),
                c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.55, 0, 0, 1, -1.1)),
            sampling=J.SamplingConfig(dt=0.05, max_steps=60)))
        bbox = ((0.3, 0.3, 0.2), (0.8, 0.9, 0.7))
    else:   # orthographic
        plan = J.Plan.create(J.PlanConfig(
            width=20, height=16, t_near=0.1, t_far=2.6, seed=4,
            camera=J.CameraConfig(
                model=J.CameraModel.ORTHOGRAPHIC, ortho_scale=0.08,
                k=(1.0, 0, 10.0, 0, 1.0, 8.0, 0, 0, 1),
                c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -0.8)),
            sampling=J.SamplingConfig(dt=0.05, max_steps=52)))
        bbox = ((0.2, 0.25, 0.15), (0.85, 0.8, 0.75))
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0.5, 8.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3), bbox_min=bbox[0],
        bbox_max=bbox[1]))
    return plan, field


NAMES = ("fixed", "stratified", "roi", "ortho", "nearest")


def jitter_of(plan):
    return j_pipe.plan_jitter_table(plan)


def planes_close(got, ref, tol=TOL, depth=TOL_DEPTH):
    for name in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   rtol=0)
    np.testing.assert_allclose(got.depth.detach().numpy(),
                               np.asarray(ref.depth), atol=depth, rtol=0)
    np.testing.assert_array_equal(got.hitmask.numpy(),
                                  np.asarray(ref.hitmask))


def schedules_equal(got, ref):
    assert (got.total_rays, got.skipped_rays, got.full_lattice_samples,
            got.windowed_samples) == (ref.total_rays, ref.skipped_rays,
                                      ref.full_lattice_samples,
                                      ref.windowed_samples)
    assert len(got.groups) == len(ref.groups)
    for a, b in zip(got.groups, ref.groups):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if y is None:
                assert x is None
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("kind", ["fixed", "stratified", "block50",
                                  "subset"])
def test_schedule_equals_reference(kind):
    plan, field = scene("stratified" if kind == "stratified" else "fixed")
    jitter = jitter_of(plan)
    kw = {}
    if kind == "block50":
        kw["block"] = 50
    if kind == "subset":
        kw["ray_subset"] = np.arange(0, plan.ray_count, 3)
    ref = j_win.build_schedule(plan, field.bbox_min, field.bbox_max,
                               jitter=jitter, device=False, **kw)
    got = p_win.build_schedule(port_plan(plan), field.bbox_min,
                               field.bbox_max, jitter=jitter, device=False,
                               **kw)
    schedules_equal(got, ref)
    if kind == "block50":
        assert len(got.groups) >= 2


@pytest.mark.parametrize("name", NAMES)
def test_windowed_planes_match_reference(name):
    plan, field = scene(name)
    jitter = jitter_of(plan)
    ref = j_win.render_windowed(plan, field, jitter=jitter)
    got = p_win.render_windowed(port_plan(plan), port_field(field),
                                jitter=jitter)
    planes_close(got, ref)


@pytest.mark.parametrize("name", ["fixed", "stratified", "nearest"])
def test_window_equals_full(name):
    """The windowed render equals the port's full-lattice render (the
    referee, with the plain integrator)."""
    plan, field = scene(name)
    pp, pf = port_plan(plan), port_field(field)
    sched = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                 jitter=jitter_of(plan), block=50,
                                 device="cpu")
    assert len(sched.groups) >= 2
    assert sched.windowed_samples < 0.8 * sched.full_lattice_samples
    assert sched.skipped_rays > 0
    with torch.no_grad():
        full = p_pipe.render(pp, pf, use_kernel=False).planes
        win = p_win.render_windowed(pp, pf, sched)
    for k in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(win, k).numpy(),
                                   getattr(full, k).numpy(), atol=1e-5)
    np.testing.assert_allclose(win.depth.numpy(), full.depth.numpy(),
                               atol=TOL_DEPTH)
    assert torch.equal(win.hitmask, full.hitmask)


CAMERA_NAMES = ("fixed", "stratified")   # camera gradients held too


@functools.lru_cache(maxsize=None)
def window_grads(name):
    """(JAX's, the port's) gradients of mean(image^2) of a named scene's
    windowed render over 64-ray groups: ((d_sigma, d_colour), d_c2w, d_k),
    the camera's (through ``k`` / ``c2w``) for CAMERA_NAMES only, else
    None. One compiled JAX program serves the grid and camera tests."""
    plan, field = scene(name)
    jitter = jitter_of(plan)
    camera = name in CAMERA_NAMES
    jsched = j_win.build_schedule(plan, field.bbox_min, field.bbox_max,
                                  jitter=jitter, block=64)
    k0 = jnp.asarray(plan.camera.k, jnp.float32).reshape(3, 3)
    c2w0 = jnp.asarray(plan.camera.c2w, jnp.float32).reshape(3, 4)

    def loss(params, c2w, k, s):
        f = field.with_params(*params)
        img = j_win.render_windowed_traced(
            plan, f, s, k=k if camera else None,
            c2w=c2w if camera else None).image
        return jnp.mean(img ** 2)

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        (field.sigma, field.color), c2w0, k0, jsched)
    pp = port_plan(plan)
    psched = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                  jitter=jitter, block=64, device="cpu")
    pf = port_field(field)
    k, c2w, _ = camera_arrays(pp, "cpu")
    k.requires_grad_(camera)
    c2w.requires_grad_(camera)
    img = p_win.render_windowed(pp, pf, psched, k=k if camera else None,
                                c2w=c2w if camera else None).image
    wrt = (pf.sigma, pf.color) + ((c2w, k) if camera else ())
    pg = torch.autograd.grad(torch.mean(img ** 2), wrt)
    if not camera:
        return (jg[0], None, None), (pg, None, None)
    return jg, (pg[:2], pg[2], pg[3])


@pytest.mark.parametrize("name", ["fixed", "stratified", "nearest", "ortho"])
def test_windowed_grid_grads_match_jax(name):
    ((gs, gc), _, _), (got, _, _) = window_grads(name)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(gs), rtol=G_RTOL,
                               atol=G_ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(gc), rtol=G_RTOL,
                               atol=G_ATOL)


@pytest.mark.parametrize("name", CAMERA_NAMES)
def test_windowed_camera_grads_match_jax(name):
    (_, jc2w, jk), (_, gc2w, gk) = window_grads(name)
    assert float(gc2w.abs().max()) > 0
    np.testing.assert_allclose(gc2w.numpy(), np.asarray(jc2w),
                               rtol=CAM_RTOL, atol=CAM_ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(jk),
                               rtol=CAM_RTOL, atol=CAM_ATOL)


@pytest.mark.parametrize("name", ["fixed", "stratified", "nearest"])
def test_pipeline_render_matches_reference(name):
    plan, field = scene(name)
    jitter = jitter_of(plan)
    ref = jax.jit(lambda f, j: j_pipe.render(plan, f, jitter=j))(
        field, None if jitter is None else jnp.asarray(jitter))
    got = p_pipe.render(port_plan(plan), port_field(field), jitter=jitter,
                        use_kernel=False)
    planes_close(got.planes, ref.planes)
    for name_ in ("t", "dt", "px", "py", "pz"):
        np.testing.assert_allclose(getattr(got.lattice, name_).numpy(),
                                   np.asarray(getattr(ref.lattice, name_)),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.lattice.mask.numpy(),
                                  np.asarray(ref.lattice.mask))
    np.testing.assert_allclose(got.sigma.detach().numpy(),
                               np.asarray(ref.sigma),
                               rtol=1e-5, atol=1e-5)
    aux, ref_aux = got.intl.aux.detach().numpy(), np.asarray(ref.intl.aux)
    np.testing.assert_allclose(aux[..., :3], ref_aux[..., :3], atol=1e-5)
    kern = p_pipe.render(port_plan(plan), port_field(field), jitter=jitter)
    assert kern.intl.aux is None
    planes_close(kern.planes, ref.planes)


def test_render_streamed_matches_reference():
    plan, field = scene("stratified")
    jitter = jitter_of(plan)

    def jloss(params, j):
        f = field.with_params(*params)
        planes = j_pipe.render_streamed(plan, f, ray_tile=100, jitter=j)
        return jnp.mean(planes.image ** 2), planes

    (_, ref), (gs, gc) = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (field.sigma, field.color), jnp.asarray(jitter))
    pp, pf = port_plan(plan), port_field(field)
    got = p_pipe.render_streamed(pp, pf, ray_tile=100)
    planes_close(got, ref)
    ps, pc = torch.autograd.grad(torch.mean(got.image ** 2),
                                 (pf.sigma, pf.color))
    np.testing.assert_allclose(ps.numpy(), np.asarray(gs), rtol=G_RTOL,
                               atol=G_ATOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(gc), rtol=G_RTOL,
                               atol=G_ATOL)


def test_generate_samples_matches_reference():
    plan, _ = scene("stratified")
    jitter = jitter_of(plan)
    n = 50
    ids = np.arange(3, 3 + 2 * n, 2, dtype=np.int32)
    offs = np.random.default_rng(1).integers(0, 30, n).astype(np.int32)
    jrays = jax.jit(lambda i: j_generate_rays(plan, ids=i))(jnp.asarray(ids))
    ref = jax.jit(lambda r, o, s: j_sampling.generate_samples(
        plan, r, ray_index_offset=o, step_offset=s, num_steps=32))(
            jrays, jnp.asarray(ids - np.arange(n)), jnp.asarray(offs))
    pp = port_plan(plan)
    rays = generate_rays(pp, ids=torch.from_numpy(ids))
    got = p_sampling.generate_samples(
        pp, rays, ray_index_offset=torch.from_numpy(ids - np.arange(n)),
        step_offset=torch.from_numpy(offs), num_steps=32)
    for name in ("t", "dt", "px", "py", "pz"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert int(got.sample_count()) == int(ref.sample_count())
    np.testing.assert_array_equal(got.ray_offsets().numpy(),
                                  np.asarray(ref.ray_offsets()))
    # precomputed rows take precedence over the host table
    rows = np.random.default_rng(2).uniform(0, 1, (n, 32)).astype(np.float32)
    ref2 = jax.jit(lambda r, j, s: j_sampling.generate_samples(
        plan, r, jitter=j, step_offset=s, num_steps=32))(
            jrays, jnp.asarray(rows), jnp.asarray(offs))
    got2 = p_sampling.generate_samples(pp, rays,
                                       jitter=torch.from_numpy(rows),
                                       step_offset=torch.from_numpy(offs),
                                       num_steps=32)
    np.testing.assert_allclose(got2.t.numpy(), np.asarray(ref2.t), atol=1e-6)


@pytest.mark.parametrize("interp", [J.InterpMode.LINEAR,
                                   J.InterpMode.NEAREST])
@pytest.mark.parametrize("oob", [J.OobPolicy.ZERO, J.OobPolicy.CLAMP])
def test_eval_grid_planes_matches_reference(interp, oob):
    rng = np.random.default_rng(int(interp) * 2 + int(oob))
    grid = rng.uniform(-1, 2, (5, 6, 7, 3)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, (3, 40, 9)).astype(np.float32)
    lo, hi = (0.1, 0.0, -0.1), (0.9, 1.1, 1.0)
    w = [rng.uniform(-1, 1, pts.shape[1:]).astype(np.float32)
         for _ in range(3)]

    def jloss(gr, px, py, pz):
        outs = j_grid.eval_grid_planes(gr, px, py, pz, lo, hi, interp, oob)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs

    (_, ref), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
            jnp.asarray(grid), *map(jnp.asarray, pts))
    g = torch.from_numpy(grid).requires_grad_(True)
    p = [torch.from_numpy(x).requires_grad_(True) for x in pts]
    got = p_grid.eval_grid_planes(g, *p, lo, hi, P.InterpMode(int(interp)),
                                  P.OobPolicy(int(oob)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6)
    loss = sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(got, w))
    pg = torch.autograd.grad(loss, [g] + p, allow_unused=True)
    for a, b in zip(pg, jg):
        a = np.zeros(np.shape(b), np.float32) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_eval_matches_reference(dtype):
    plan, field = scene("fixed")
    field = field.with_packed_dtype(dtype)
    rng = np.random.default_rng(8)
    pts = [rng.uniform(0.1, 1.0, (30, 11)).astype(np.float32)
           for _ in range(3)]
    ref = jax.jit(lambda f, *p: f.packed_eval_planes(*p))(
        field, *map(jnp.asarray, pts))
    pf = port_field(field).with_packed_dtype(dtype)
    assert pf.supports_packed_eval
    got = pf.packed_eval_planes(*map(torch.from_numpy, pts))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL)
    table = p_grid.build_packed_stencil(pf.sigma, pf.color)
    np.testing.assert_array_equal(
        table.detach().numpy(),
        np.asarray(jax.jit(j_grid.build_packed_stencil)(field.sigma,
                                                        field.color)))


def test_sparse_packed_eval_matches_reference():
    plan, field = scene("fixed")
    jsp = JSparse.from_dense(field, threshold=2.0)
    psp = P.SparseGridField.from_reference(
        np.asarray(jsp.bricks), np.asarray(jsp.occupancy), jsp.grid_shape,
        jsp.bbox_min, jsp.bbox_max, device="cpu")
    rng = np.random.default_rng(9)
    pts = [rng.uniform(0.1, 1.0, (30, 11)).astype(np.float32)
           for _ in range(3)]
    ref = jax.jit(lambda f, *p: f.packed_eval_planes(*p))(
        jsp, *map(jnp.asarray, pts))
    got = psp.packed_eval_planes(*map(torch.from_numpy, pts))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=TOL)
    jimg = j_win.render_windowed(plan, jsp)
    pimg = p_win.render_windowed(port_plan(plan), psp)
    planes_close(pimg, jimg)


def test_compose_matches_reference():
    rng = np.random.default_rng(4)
    w, h, n = 7, 5, 20
    pids = rng.permutation(w * h)[:n].astype(np.int32)
    pids[-3:] = w * h + np.arange(3)      # padding rays: dropped
    rad = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tr, op, dep = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(3))
    ref = j_compose.compose(*map(jnp.asarray, (pids, rad, tr, op, dep)), w,
                            h, 3.5)
    got = p_compose.compose(*map(torch.from_numpy, (pids, rad, tr, op, dep)),
                            w, h, 3.5)
    for name in ("image", "transmittance", "opacity", "depth", "hitmask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    # the compose of rays that share pixels: pixel 0 takes three rays
    pids[1:3] = pids[0]
    ref = j_compose.compose(*map(jnp.asarray, (pids, rad, tr, op, dep)), w,
                            h, 3.5, unique_pixels=False)
    got = p_compose.compose(*map(torch.from_numpy, (pids, rad, tr, op, dep)),
                            w, h, 3.5, unique_pixels=False)
    for name in ("image", "transmittance", "opacity", "depth", "hitmask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def _stack(mode):
    plan, field = windowed_scene(mode=mode)
    cams = []
    for i in range(3):
        ang = 2 * math.pi * i / 3
        cams.append(J.CameraConfig(
            k=plan.camera.k,
            c2w=(1, 0, 0, 0.5 + 0.2 * math.sin(ang), 0, 1, 0,
                 0.55 + 0.1 * math.cos(ang), 0, 0, 1, -1.1)))
    return plan, field, j_view_plans(plan, cams)


@pytest.mark.parametrize("mode", [J.SamplingMode.FIXED,
                                  J.SamplingMode.STRATIFIED])
def test_stack_matches_reference(mode):
    plan, field, plans = _stack(mode)
    jitter = jitter_of(plan)
    ref_s = j_win.build_stack_schedule(plans, field.bbox_min, field.bbox_max,
                                       block=128, jitter=jitter)
    pplans = [port_plan(p) for p in plans]
    got_s = p_win.build_stack_schedule(pplans, field.bbox_min,
                                       field.bbox_max, block=128,
                                       jitter=jitter, device="cpu")
    assert (got_s.n_views, got_s.view_hw) == (ref_s.n_views, ref_s.view_hw)
    schedules_equal(got_s, ref_s)
    pf = port_field(field)
    stack = p_win.render_windowed_stack(pplans[0], pf, got_s)
    ref = np.asarray(jax.jit(lambda f, s: j_win.render_windowed_stack(
        plan, f, s))(field, ref_s))
    np.testing.assert_allclose(stack.detach().numpy(), ref, atol=TOL)
    for v, pv in enumerate(pplans):
        single = p_win.render_windowed(pv, pf, jitter=jitter)
        np.testing.assert_allclose(stack[v].detach().numpy(),
                                   single.image.detach().numpy(), atol=TOL,
                                   rtol=0)


def test_stack_gradients_match_jax():
    plan, field, plans = _stack(J.SamplingMode.STRATIFIED)
    jitter = jitter_of(plan)
    ref_s = j_win.build_stack_schedule(plans, field.bbox_min, field.bbox_max,
                                       jitter=jitter)

    def jloss(params, s):
        f = field.with_params(*params)
        return jnp.mean(j_win.render_windowed_stack(plan, f, s) ** 2)

    gs, gc = jax.jit(jax.grad(jloss))((field.sigma, field.color), ref_s)
    pplans = [port_plan(p) for p in plans]
    sched = p_win.build_stack_schedule(pplans, field.bbox_min,
                                       field.bbox_max, jitter=jitter,
                                       device="cpu")
    pf = port_field(field)
    loss = torch.mean(p_win.render_windowed_stack(pplans[0], pf, sched,
                                                  remat=True) ** 2)
    ps, pc = torch.autograd.grad(loss, (pf.sigma, pf.color))
    np.testing.assert_allclose(ps.numpy(), np.asarray(gs), rtol=G_RTOL,
                               atol=G_ATOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(gc), rtol=G_RTOL,
                               atol=G_ATOL)


@pytest.mark.parametrize("name", ["fixed", "stratified"])
def test_renderer_windowed_matches_reference(name):
    plan, field = scene(name)
    jr = J.Renderer(J.Context.create(), plan,
                    J.RenderOptions(use_window=True, use_tiles=False))
    jf = jr.forward(field)
    dl = np.random.default_rng(3).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    jb = jr.backward(field, dl)
    pr = P.Renderer(P.Context.create(device="cpu"), port_plan(plan),
                    P.RenderOptions(use_window=True))
    pf = port_field(field)
    got = pr.forward(pf)
    assert "windowed_path" in got.stats.notes
    for k in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, k), getattr(jf, k), atol=TOL)
    np.testing.assert_allclose(got.depth, jf.depth, atol=TOL_DEPTH)
    np.testing.assert_array_equal(got.hitmask, jf.hitmask)
    gb = pr.backward(pf, dl)
    for k in ("sigma", "color"):
        want = getattr(jb, k)
        np.testing.assert_allclose(getattr(gb, k), want, rtol=0,
                                   atol=GRID_TOL * np.abs(want).max())
    np.testing.assert_allclose(gb.camera, jb.camera, rtol=CAM_RTOL,
                               atol=CAM_ATOL)
    np.testing.assert_allclose(gb.camera_k, jb.camera_k, rtol=CAM_RTOL,
                               atol=CAM_ATOL)
    again = pr.backward(pf, dl)
    assert np.array_equal(again.sigma, gb.sigma)


def test_windowed_rejects_clamp_and_unbounded_fields():
    plan, field = scene("fixed")
    pf = port_field(field)
    clamp = pf.__class__(pf.sigma, pf.color, bbox_min=pf.bbox_min,
                         bbox_max=pf.bbox_max, oob=P.OobPolicy.CLAMP)
    with pytest.raises(DvrenError):
        p_win.render_windowed(port_plan(plan), clamp)
    hm = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                    spec=P.HashMLPSpec(), device="cpu")
    r = P.Renderer(P.Context.create(device="cpu"), port_plan(plan),
                   P.RenderOptions(use_window=True))
    with pytest.raises(DvrenError):
        r.forward(hm)


def test_windowed_background_when_the_bbox_is_missed():
    plan, field = windowed_scene(bbox=((5.0, 5.0, 5.0), (6.0, 6.0, 6.0)))
    ref = j_win.render_windowed(plan, field)
    pp = port_plan(plan)
    sched = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                 device="cpu")
    assert not sched.groups
    got = p_win.render_windowed(pp, port_field(field), sched)
    planes_close(got, ref)


def test_take_rows_backward_is_repeatable():
    rng = np.random.default_rng(12)
    table = torch.from_numpy(rng.uniform(0, 1, (50, 32)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, 4000))
    g = torch.from_numpy(rng.uniform(-1, 1, (4000, 32)).astype(np.float32))
    outs = []
    for _ in range(2):
        t = table.clone().requires_grad_(True)
        (d,) = torch.autograd.grad((p_grid.take_rows(t, idx) * g).sum(), t)
        outs.append(d)
    assert torch.equal(outs[0], outs[1])
    want = torch.zeros(50, 32, dtype=torch.float64).index_add_(
        0, idx, g.double())
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), atol=1e-5)


def test_accumulate_rows_sums_in_sample_order():
    """accumulate_rows sums each index's rows in their sample order (bit
    for bit a sequential float32 sum from the first row), adds that sum
    to the row once, and leaves torch's deterministic mode as it was."""
    rng = np.random.default_rng(13)
    idx = torch.from_numpy(rng.integers(0, 40, 3000))
    rows = torch.from_numpy(rng.uniform(-1, 1, (3000, 4)).astype(np.float32))
    start = rng.uniform(-1, 1, (40, 4)).astype(np.float32)
    sums = np.zeros((40, 4), np.float32)
    for i, r in zip(idx.numpy(), rows.numpy()):
        sums[i] = sums[i] + r
    flag = torch.are_deterministic_algorithms_enabled()
    seg = p_grid.accumulate_rows(torch.zeros(40, 4), idx, rows)
    got = p_grid.accumulate_rows(torch.from_numpy(start.copy()), idx, rows)
    assert torch.are_deterministic_algorithms_enabled() == flag
    assert np.array_equal(seg.numpy(), sums)
    assert np.array_equal(got.numpy(), start + sums)


def test_entry_points_default_to_the_card():
    """generate_rays(plan) and roi_hitmask(plan) take Context's default
    device: CUDA, which raises where torch has none; named "cpu" they
    run on the CPU."""
    plan, _ = scene("fixed")
    pp = port_plan(plan)
    cpu_rays = generate_rays(pp, device="cpu")
    assert cpu_rays.origins.device.type == "cpu"
    assert p_win.roi_hitmask(pp, "cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert generate_rays(pp).origins.device.type == "cuda"
        assert p_win.roi_hitmask(pp).device.type == "cuda"
    else:
        with pytest.raises(DvrenError):
            generate_rays(pp)
        with pytest.raises(DvrenError):
            p_win.roi_hitmask(pp)
        with pytest.raises(DvrenError):
            p_win.build_schedule(pp, (0, 0, 0), (1, 1, 1))
