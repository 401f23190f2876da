"""The tiled schedule's windowed fallback and the windowed and plain fit
modes of dvren_tpu_torch against dvren_tpu, on the CPU.

Scenes: tests/test_tiled.py's partial-fallback scene (32^2 over a 20^3
blob whose 8 px sub-tiles partly overflow: 64 of 1024 rays fall back;
at 16 px cells 640 do) and its 16 px overflow scene (96^2 over 32^3),
tests/test_tiled.py::test_merged_views_fallback_uses_view_camera's two
views (16 px over 32^3, stratified), and tests/test_fit.py's four 12^2
views for the fit. The JAX side runs its jnp paths: the numpy schedule
builder with its fallback, ``render_tiled(use_kernel=False)``,
``render_tiled_stack(use_kernel=False)``, ``render_windowed_traced``,
``pipeline.render`` and ``jax.grad`` of them, and ``fit_dense_grid`` in
its windowed and plain modes. Held:

- schedules, fallback schedules included, equal to JAX's array for array;
- planes within 5e-6 (depth 1e-4) of JAX's, within 1e-5 of the full
  render; the merged stack within 5e-6 of JAX's and equal to each view's
  own render;
- grid gradients within rtol 1e-4 / atol 1e-8 (tests/test_windowed.py's
  bound); camera gradients within rtol 2e-3 / atol 1e-4 of the windowed
  path's;
- the Renderer's tiled mode with fallback rays, forward and backward, and
  the auto mode's demotion to the windowed path (as
  tests/test_renderer_streaming.py's test shows it for JAX);
- ``fit_dense_grid`` windowed, plain and auto-demoted: loss histories
  within rtol 1e-4 of JAX's over a few Adam steps, ``result.mode`` the
  mode that ran.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.opt import fit as j_fit
from dvren_tpu.render import pipeline as j_pipe
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render import windowed as j_win
from tests import test_fit
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.ops.raygen import camera_arrays
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
G_RTOL, G_ATOL = 1e-4, 1e-8
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4
LOSS_RTOL = 1e-4


def partial_scene():
    """tests/test_tiled.py::test_subtiled_partial_fallback's scene."""
    n, w = 20, 32
    plan = J.Plan.create(J.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.6,
        camera=J.CameraConfig(
            k=(w * 1.25, 0, w / 2, 0, w * 1.25, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.3, 0, 1, 0, 0.3, 0, 0, 1, -1.0)),
        sampling=J.SamplingConfig(dt=0.04, max_steps=60)))
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r2 = (xs - 0.3) ** 2 + (ys - 0.3) ** 2 + (zs - 0.3) ** 2
    sigma = 15.0 * np.exp(-r2 / 0.1)
    sigma[sigma < 1e-3] = 0.0
    color = np.stack([xs, ys, zs], axis=-1)
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.astype(np.float32).reshape(-1),
        color=color.astype(np.float32).reshape(-1)))
    return plan, field


def overflow_scene():
    """tests/test_tiled.py::test_subtiled_rescues_fine_grid_overflow's
    scene: 96^2 over 32^3, whose 16 px cell tiles overflow."""
    rng = np.random.default_rng(9)
    n, w = 32, 96
    plan = J.Plan.create(J.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=3,
        camera=J.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=J.SamplingConfig(dt=2.0 / 64, max_steps=64)))
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0.5, 8.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3)))
    return plan, field


SCENES = {"partial": (partial_scene, 8), "overflow16": (overflow_scene, 16)}


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX plan, field, schedule with fallback; port plan, field,
    schedule) of a named scene at its tile size."""
    make, px = SCENES[name]
    plan, field = make()
    ref = j_tiled.build_tiled_schedule(plan, field, tile_px=px, device=False)
    pplan, pfield = port_plan(plan), port_field(field)
    got = p_tiled.build_tiled_schedule(pplan, pfield, tile_px=px)
    return plan, field, ref, pplan, pfield, got


def jax_tiled(plan, field, sched):
    """JAX's reference consumer (``render_tiled(use_kernel=False)``),
    compiled once: op by op it would compile every jnp call."""
    return jax.jit(lambda f, s: j_tiled.render_tiled(
        plan, f, s, use_kernel=False))(field, sched)


GRAD_CASE = "partial"   # the case whose grid gradients are held to JAX's


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """(JAX's reference frame of a named case, and for GRAD_CASE the grid
    gradients of mean(image^2) from the same compiled program, else
    None), computed once for the tests that share them."""
    plan, field, ref, _, _, _ = case(name)
    if name != GRAD_CASE:
        return jax_tiled(plan, field, ref), None

    def jloss(params, s):
        f = field.with_params(*params)
        planes = j_tiled.render_tiled(plan, f, s, use_kernel=False)
        return jnp.mean(planes.image ** 2), planes

    (_, planes), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (field.sigma, field.color), ref)
    return planes, grads


def planes_close(got, ref, tol=TOL, depth=TOL_DEPTH):
    for name in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   rtol=0)
    np.testing.assert_allclose(got.depth.detach().numpy(),
                               np.asarray(ref.depth), atol=depth, rtol=0)
    np.testing.assert_array_equal(got.hitmask.numpy(),
                                  np.asarray(ref.hitmask))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fallback_schedule_equals_reference(name):
    _, _, ref, _, _, got = case(name)
    assert 0 < got.fallback_rays < got.total_rays
    assert got.fallback is not None and got.fallback.groups
    assert_schedules_equal(ref, got)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fallback_planes_match_reference(name):
    plan, field, ref, pplan, pfield, got = case(name)
    want, _ = jax_reference(name)
    with torch.no_grad():
        planes = p_tiled.render_tiled(pplan, pfield, got.to("cpu"))
    planes_close(planes, want)
    full = jax.jit(lambda f: j_pipe.render(plan, f).planes)(field)
    planes_close(planes, full, tol=1e-5)


def test_fallback_grid_grads_match_jax():
    _, _, _, pplan, pfield, got = case(GRAD_CASE)
    _, (gs, gc) = jax_reference(GRAD_CASE)
    leaf = pfield.with_params(pfield.sigma.detach().clone(),
                              pfield.color.detach().clone())
    loss = torch.mean(p_tiled.render_tiled(pplan, leaf, got.to("cpu")).image
                      ** 2)
    ps, pc = torch.autograd.grad(loss, (leaf.sigma, leaf.color))
    np.testing.assert_allclose(ps.numpy(), np.asarray(gs), rtol=G_RTOL,
                               atol=G_ATOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(gc), rtol=G_RTOL,
                               atol=G_ATOL)


def test_fallback_camera_grads_match_windowed():
    """Camera gradients through the tiles and the fallback together equal
    JAX's windowed path's (the same frame, another schedule)."""
    plan, field, _, pplan, pfield, got = case("partial")
    k0 = jnp.asarray(plan.camera.k, jnp.float32).reshape(3, 3)
    c2w0 = jnp.asarray(plan.camera.c2w, jnp.float32).reshape(3, 4)
    wsched = j_win.build_schedule(plan, field.bbox_min, field.bbox_max)

    def jloss(c2w, k, s):
        img = j_win.render_windowed_traced(plan, field, s, k=k,
                                           c2w=c2w).image
        return jnp.mean(img ** 2)

    jc2w, jk = jax.jit(jax.grad(jloss, argnums=(0, 1)))(c2w0, k0, wsched)
    k, c2w, _ = camera_arrays(pplan, "cpu")
    k.requires_grad_(True)
    c2w.requires_grad_(True)
    img = p_tiled.render_tiled(pplan, pfield, got.to("cpu"), k=k,
                               c2w=c2w).image
    gc2w, gk = torch.autograd.grad(torch.mean(img ** 2), (c2w, k))
    assert float(gc2w.abs().max()) > 0
    np.testing.assert_allclose(gc2w.numpy(), np.asarray(jc2w),
                               rtol=CAM_RTOL, atol=CAM_ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(jk), rtol=CAM_RTOL,
                               atol=CAM_ATOL)


def test_all_rays_fall_back():
    """At 16 px cells the partial scene's only group overflows on 640 of
    its 1024 rays; the frame is still the full render."""
    plan, field = partial_scene()
    pplan, pfield = port_plan(plan), port_field(field)
    s16 = p_tiled.build_tiled_schedule(pplan, pfield, tile_px=16)
    ref = j_tiled.build_tiled_schedule(plan, field, tile_px=16, device=False)
    assert s16.fallback_rays == ref.fallback_rays == 640
    assert_schedules_equal(ref, s16)
    with torch.no_grad():
        planes = p_tiled.render_tiled(pplan, pfield, s16.to("cpu"))
    planes_close(planes, jax_tiled(plan, field, ref))


@functools.lru_cache(maxsize=None)
def merged_case():
    """The two-view stack: (JAX's per-view schedules, merged schedule,
    stack, and grid gradients of mean(stack^2) from the same compiled
    program; the port's plans, field and per-view schedules)."""
    plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED, n=32)
    jitter = j_pipe.plan_jitter_table(plan)
    cams = [J.CameraConfig(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.55, 0, 0, 1,
                                -1.1)) for dx in (0.0, 0.15)]
    plans = j_fit.view_plans(plan, cams)
    jscheds = [j_tiled.build_tiled_schedule(p, field, jitter=jitter,
                                            tile_px=16, quantize=True,
                                            device=False) for p in plans]
    ref = j_tiled.merge_view_schedules(jscheds, plans=plans)

    def jloss(params, m):
        f = field.with_params(*params)
        stack = j_tiled.render_tiled_stack(plan, f, m, use_kernel=False)
        return jnp.mean(stack ** 2), stack

    (_, stack), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        (field.sigma, field.color), ref)
    pplans = [port_plan(p) for p in plans]
    pfield = port_field(field)
    scheds = [p_tiled.build_tiled_schedule(p, pfield, jitter=jitter,
                                           tile_px=16, quantize=True)
              for p in pplans]
    return jscheds, ref, np.asarray(stack), grads, pplans, pfield, scheds


def test_merged_views_fallback_matches_reference():
    jscheds, ref, want, _, pplans, pfield, scheds = merged_case()
    assert any(s.fallback_rays > 0 for s in jscheds)
    for a, b in zip(jscheds, scheds):
        assert_schedules_equal(a, b)
    with pytest.raises(P.DvrenError, match="plans="):
        p_tiled.merge_view_schedules(scheds)
    merged = p_tiled.merge_view_schedules(scheds, plans=pplans).to("cpu")
    assert merged.view_cams == ref.view_cams
    with torch.no_grad():
        stack = p_tiled.render_tiled_stack(pplans[0], pfield, merged)
        np.testing.assert_allclose(stack.numpy(), want, atol=TOL, rtol=0)
        for v, p in enumerate(pplans):
            single = p_tiled.render_tiled(p, pfield, scheds[v].to("cpu"))
            np.testing.assert_allclose(stack[v].numpy(),
                                       single.image.numpy(), atol=TOL, rtol=0)


def test_merged_views_fallback_gradients_match_jax():
    _, _, _, (gs, gc), pplans, pfield, scheds = merged_case()
    leaf = pfield.with_params(pfield.sigma.detach().clone(),
                              pfield.color.detach().clone())
    merged = p_tiled.merge_view_schedules(scheds, plans=pplans).to("cpu")
    loss = torch.mean(p_tiled.render_tiled_stack(pplans[0], leaf, merged)
                      ** 2)
    ps, pc = torch.autograd.grad(loss, (leaf.sigma, leaf.color))
    np.testing.assert_allclose(ps.numpy(), np.asarray(gs), rtol=G_RTOL,
                               atol=G_ATOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(gc), rtol=G_RTOL,
                               atol=G_ATOL)


def test_renderer_tiled_with_fallback():
    """Renderer(use_tiles=True) on the 16 px overflow scene, its schedule
    pinned at 16 px cells: the frame is JAX's reference consumer's, the
    grid gradients autograd's of ``render_tiled`` (held to ``jax.grad``
    by test_fallback_grid_grads_match_jax), the camera gradients the
    windowed Renderer's."""
    plan, field, ref, pplan, pfield, got = case("overflow16")
    r = P.Renderer(P.Context.create(device="cpu"), pplan,
                   P.RenderOptions(use_tiles=True))
    r._tiled_schedule = got.to("cpu")
    r._tiled_key = r._tiled_schedule_key(pfield)
    fr = r.forward(pfield)
    assert "tiled_path" in fr.stats.notes
    want, _ = jax_reference("overflow16")
    np.testing.assert_allclose(fr.image, np.asarray(want.image).reshape(-1),
                               atol=TOL)
    dl = np.random.default_rng(5).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    gb = r.backward(pfield, dl)
    leaf = pfield.with_params(pfield.sigma.detach().clone(),
                              pfield.color.detach().clone())
    k0, c2w0, _ = camera_arrays(pplan, "cpu")
    img = p_tiled.render_tiled(pplan, leaf, got.to("cpu"),
                               k=k0.requires_grad_(),
                               c2w=c2w0.requires_grad_()).image
    want_s, want_c = torch.autograd.grad(
        torch.sum(img * torch.from_numpy(dl).reshape(img.shape)),
        (leaf.sigma, leaf.color))
    np.testing.assert_array_equal(gb.sigma, want_s.numpy().reshape(-1))
    np.testing.assert_array_equal(gb.color, want_c.numpy().reshape(-1))
    w = P.Renderer(P.Context.create(device="cpu"), pplan,
                   P.RenderOptions(use_window=True))
    w.forward(pfield)
    wb = w.backward(pfield, dl)
    np.testing.assert_allclose(gb.camera, wb.camera, rtol=CAM_RTOL,
                               atol=CAM_ATOL)
    np.testing.assert_allclose(gb.camera_k, wb.camera_k, rtol=CAM_RTOL,
                               atol=CAM_ATOL)


def test_auto_tiles_demotes_on_heavy_fallback(monkeypatch):
    """When most rays still fall back, the auto mode takes the windowed
    path (note ``tiled_demoted_to_windowed``) and the backward
    differentiates the windowed replay, camera included."""
    plan, field = partial_scene()
    pplan, pfield = port_plan(plan), port_field(field)
    real = p_tiled.build_tiled_schedule

    def heavy(*a, **kw):
        s = real(*a, **kw)
        return dataclasses.replace(s, fallback_rays=s.total_rays)

    monkeypatch.setattr(p_tiled, "build_tiled_schedule", heavy)
    r = P.Renderer(P.Context.create(device="cpu"), pplan)
    monkeypatch.setattr(r, "_use_tiles", lambda f: True)   # as on the card
    fr = r.forward(pfield)
    assert "tiled_demoted_to_windowed: most rays fall back" in fr.stats.notes
    assert "windowed_path" in fr.stats.notes
    w = P.Renderer(P.Context.create(device="cpu"), pplan,
                   P.RenderOptions(use_window=True))
    wf = w.forward(pfield)
    np.testing.assert_array_equal(fr.image, wf.image)
    dl = np.ones(plan.ray_count * 3, np.float32)
    br = r.backward(pfield, dl)
    wb = w.backward(pfield, dl)
    assert np.abs(br.camera).sum() > 0
    np.testing.assert_array_equal(br.sigma, wb.sigma)
    np.testing.assert_array_equal(br.camera, wb.camera)


# --------------------------------------------------------------- the fit


@functools.lru_cache(maxsize=None)
def fit_scene():
    plan, field, cams = (test_fit.make_plan(), test_fit.truth_field(),
                         test_fit.cameras())
    targets = np.asarray(jax.jit(
        lambda f: j_fit.render_views(plan, f, cams))(field))
    init = field.with_params(jnp.full_like(field.sigma, 0.5),
                             jnp.full_like(field.color, 0.5))
    pcams = [P.CameraConfig(c2w=tuple(c.c2w)) for c in cams]
    return plan, init, cams, targets, port_plan(plan), port_field(init), pcams


def _fits(mode, steps, field_of=lambda f: f, pfield_of=lambda f: f):
    plan, init, cams, targets, pplan, pinit, pcams = fit_scene()
    cfg = dict(learning_rate=5e-2, steps=steps, target_psnr=None)
    ref = j_fit.fit_dense_grid(plan, field_of(init), list(cams), targets,
                               j_fit.FitConfig(**cfg), mode=mode)
    got = p_fit.fit_dense_grid(pplan, pfield_of(pinit), list(pcams), targets,
                               p_fit.FitConfig(**cfg), mode=mode)
    return ref, got


@pytest.mark.parametrize("mode, steps", [("windowed", 4), ("plain", 3)])
def test_fit_mode_matches_jax(mode, steps):
    ref, got = _fits(mode, steps)
    assert got.mode == ref.mode == mode
    assert got.steps_run == ref.steps_run == steps
    np.testing.assert_allclose(got.loss_history, ref.loss_history,
                               rtol=LOSS_RTOL)
    assert got.loss_history[-1] < got.loss_history[0]
    np.testing.assert_allclose(got.field.sigma.detach().numpy(),
                               np.asarray(ref.field.sigma), atol=1e-4)


def test_fit_auto_mode_on_a_nearest_field_is_windowed():
    """``scheduled_mode_for`` gives "windowed" for a nearest field, and the
    auto fit runs it, as JAX's does."""
    def nearest(f):
        return f.__class__(sigma=f.sigma, color=f.color, bbox_min=f.bbox_min,
                           bbox_max=f.bbox_max, interp=J.InterpMode.NEAREST)

    def p_nearest(f):
        return P.DenseGridField(f.sigma.detach(), f.color.detach(),
                                bbox_min=f.bbox_min, bbox_max=f.bbox_max,
                                interp=P.InterpMode.NEAREST)

    ref, got = _fits(None, 2, nearest, p_nearest)
    assert got.mode == ref.mode == "windowed"
    np.testing.assert_allclose(got.loss_history, ref.loss_history,
                               rtol=LOSS_RTOL)


def test_fit_auto_demotion_runs_windowed():
    """tests/test_fit.py's views are coarse for the grid: the merged
    tables outnumber the lattice, so the auto mode demotes to windowed
    and fits, as JAX's does."""
    ref, got = _fits(None, 2)
    assert got.mode == ref.mode == "windowed"
    np.testing.assert_allclose(got.loss_history, ref.loss_history,
                               rtol=LOSS_RTOL)
