"""dvren_tpu_torch.ops.diff against dvren_tpu.ops.diff, on the CPU.

``per_sample_grads`` (the radiance head's adjoint per sample: K9b's
function, its plain twin here) against JAX's ``jax.vjp`` of
``radiance_only`` on seeded lattices, with early termination, a partial
mask and exact zeros of sigma * dt (JAX's tie value 0.5 of d max(x, 0) at
x == 0); ``camera_grads`` against JAX's at pinhole and orthographic
cameras, fixed and stratified (the forward's jitter table), and the field
evaluation's point forms (``eval_grid``, ``scatter_grid_grads``,
``sigma_at`` / ``color_at``, ``accumulate_sample_gradients``). Bounds:
per-sample and grid gradients 2e-6 x scale, camera rtol 2e-3 / atol 1e-4.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.ops import diff as j_diff
from dvren_tpu.ops import grid as j_grid
from dvren_tpu.render.pipeline import plan_jitter_table as j_jitter
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import diff as p_diff
from dvren_tpu_torch.ops import grid as p_grid
from dvren_tpu_torch.ops import integrate_fused

torch.set_num_threads(1)

GRID_TOL = 2e-6
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4


def close(got, ref, tol=GRID_TOL, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * scale, err_msg=what)


def lattice(kind, seed=3, n=9, k=40):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0.2, 4.0, (n, k)).astype(np.float32)
    if kind == "opaque":
        sigma *= 40.0                       # rays stop early
    dt = np.full((n, k), 0.05, np.float32)
    mask = np.ones((n, k), bool)
    if kind == "ties":
        sigma[:, ::3] = 0.0                 # sigma * dt == 0 on live steps
        sigma[2, :] = 0.0
        dt[4, 5:9] = 0.0
    if kind in ("partial", "ties"):
        for r in range(n):
            mask[r, rng.integers(k // 3, k + 1):] = False
        dt = np.where(mask, dt, 0.0).astype(np.float32)
        sigma = np.where(mask, sigma, 0.0).astype(np.float32)
    color = rng.uniform(0, 1, (n, k, 3)).astype(np.float32)
    color = np.where(mask[..., None], color, 0.0).astype(np.float32)
    g = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return sigma, color, dt, mask, g


@pytest.mark.parametrize("kind", ["plain", "opaque", "partial", "ties"])
@pytest.mark.parametrize("planes", [False, True])
def test_per_sample_grads_match_jax(kind, planes):
    sigma, color, dt, mask, g = lattice(kind)
    j_color = (tuple(jnp.asarray(color[..., c]) for c in range(3)) if planes
               else jnp.asarray(color))
    ref_s, ref_c = j_diff.per_sample_grads(
        jnp.asarray(g), jnp.asarray(sigma), j_color, jnp.asarray(dt),
        jnp.asarray(mask))
    t = torch.from_numpy
    p_color = (tuple(t(np.ascontiguousarray(color[..., c])) for c in range(3))
               if planes else t(color))
    before = integrate_fused.radiance_vjp.launches
    got_s, got_c = p_diff.per_sample_grads(t(g), t(sigma), p_color, t(dt),
                                           t(mask))
    assert integrate_fused.radiance_vjp.launches == before   # CPU: the twin
    assert tuple(got_c.shape) == tuple(ref_c.shape) == sigma.shape + (3,)
    close(got_s.numpy(), ref_s, what="d_sigma")
    close(got_c.numpy(), ref_c, what="d_color")


def test_per_sample_grads_tie_is_half():
    """At sigma * dt == 0 on a live step, d_sigma takes half the one-sided
    derivative, as JAX's autodiff does (tests/test_torch_integrate.py)."""
    sigma, color, dt, mask, g = lattice("ties")
    ref_s, _ = j_diff.per_sample_grads(
        jnp.asarray(g), jnp.asarray(sigma), jnp.asarray(color),
        jnp.asarray(dt), jnp.asarray(mask))
    t = torch.from_numpy
    got_s, _ = p_diff.per_sample_grads(t(g), t(sigma), t(color), t(dt),
                                       t(mask))
    tie = (sigma * dt == 0) & mask & (dt > 0)
    assert tie.sum() > 10
    assert np.abs(np.asarray(ref_s)[tie]).max() > 0
    close(got_s.numpy()[tie], np.asarray(ref_s)[tie])


@functools.lru_cache(maxsize=None)
def cam_scene(camera, sampling):
    rng = np.random.default_rng(5)
    n = 6
    if camera == "ortho":
        cam = J.CameraConfig(
            model=J.CameraModel.ORTHOGRAPHIC,
            k=(9.0, 0, 4.5, 0, 9.0, 3.5, 0, 0, 1), ortho_scale=0.8,
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -0.9))
    else:
        cam = J.CameraConfig(
            k=(12.0, 0, 5.0, 0, 12.0, 4.0, 0, 0, 1),
            c2w=(0.98, 0, 0.2, 0.45, 0, 1, 0, 0.53, -0.2, 0, 0.98, -0.9))
    plan = J.Plan.create(J.PlanConfig(
        width=10, height=8, t_near=0.3, t_far=2.1, seed=9, camera=cam,
        sampling=J.SamplingConfig(
            dt=0.06, max_steps=32,
            mode=(J.SamplingMode.STRATIFIED if sampling == "stratified"
                  else J.SamplingMode.FIXED))))
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0.1, 1.0, 3 * n ** 3)))
    dl = rng.uniform(-1, 1, (plan.ray_count, 3)).astype(np.float32)
    jit = j_jitter(plan)
    ref = j_diff.camera_grads(plan, field, jnp.asarray(dl),
                              jitter=None if jit is None
                              else jnp.asarray(jit))
    return plan, field, dl, {k: np.asarray(v) for k, v in ref.items()}


def off_lattice_planes(plan, field) -> float:
    """The least distance, in cells, of a live sample from a grid plane:
    on a plane the trilinear slope jumps, and a last-bit difference in
    the local coordinate picks the other side's."""
    from dvren_tpu.ops.raygen import generate_rays
    from dvren_tpu.ops.sampling import generate_samples
    lat = generate_samples(plan, generate_rays(plan))
    pos = np.asarray(lat.positions)[np.asarray(lat.mask)].astype(np.float64)
    lo, hi = np.asarray(field.bbox_min), np.asarray(field.bbox_max)
    cells = (pos - lo) / (hi - lo) * (np.asarray(field.resolution) - 1)
    return float(np.abs(cells - np.round(cells)).min())


@pytest.mark.parametrize("sampling", ["fixed", "stratified"])
@pytest.mark.parametrize("camera", ["pinhole", "ortho"])
def test_camera_grads_match_jax(camera, sampling):
    plan, field, dl, ref = cam_scene(camera, sampling)
    assert off_lattice_planes(plan, field) > 1e-6
    pplan = port_plan(plan)
    jit = P.render.pipeline.plan_jitter_table(pplan)
    got = p_diff.camera_grads(
        pplan, port_field(field), torch.from_numpy(dl),
        jitter=None if jit is None else torch.from_numpy(jit.copy()))
    for key in ("c2w", "k", "ortho_scale"):
        assert tuple(got[key].shape) == ref[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), ref[key],
                                   rtol=CAM_RTOL, atol=CAM_ATOL, err_msg=key)
    assert np.abs(ref["c2w"]).max() > 1e-2
    if camera == "ortho":
        assert abs(float(ref["ortho_scale"])) > 1e-3


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("oob", ["zero", "clamp"])
def test_point_forms_and_scatter_match_jax(interp, oob):
    rng = np.random.default_rng(11)
    n = 5
    j_interp = (J.InterpMode.LINEAR if interp == "linear"
                else J.InterpMode.NEAREST)
    j_oob = J.OobPolicy.ZERO if oob == "zero" else J.OobPolicy.CLAMP
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n + 1, n + 2), sigma=rng.uniform(0, 3, n * (n + 1)
                                                        * (n + 2)),
        color=rng.uniform(0, 1, 3 * n * (n + 1) * (n + 2)),
        bbox_min=(0.1, 0.0, 0.2), bbox_max=(0.9, 1.1, 0.8),
        interp=j_interp, oob=j_oob))
    pf = port_field(field)
    pos = rng.uniform(-0.1, 1.1, (7, 13, 3)).astype(np.float32)
    gs = rng.uniform(-1, 1, (7, 13)).astype(np.float32)
    gc = rng.uniform(-1, 1, (7, 13, 3)).astype(np.float32)
    jp = jnp.asarray(pos)
    t = torch.from_numpy
    close(pf.sigma_at(t(pos)).detach().numpy(), field.sigma_at(jp), 1e-6)
    close(pf.color_at(t(pos)).detach().numpy(), field.color_at(jp), 1e-6)
    ref = field.accumulate_sample_gradients(jp, jnp.asarray(gs),
                                            jnp.asarray(gc))
    zs, zc = pf.zero_grads()
    got = pf.accumulate_sample_gradients(t(pos), t(gs), t(gc), (zs, zc))
    close(got[0].numpy(), ref[0], what="sigma")
    close(got[1].numpy(), ref[1], what="color")
    assert not zs.requires_grad and float(zs.abs().max()) == 0.0
    direct = p_grid.scatter_grid_grads(
        tuple(pf.sigma.shape), t(pos), t(gs), pf.bbox_min, pf.bbox_max,
        pf.interp, pf.oob)
    np.testing.assert_array_equal(direct.numpy(), got[0].numpy())
    ref_grid = j_grid.eval_grid(field.color, jp, field.bbox_min,
                                field.bbox_max, j_interp, j_oob)
    got_grid = p_grid.eval_grid(pf.color.detach(), t(pos), pf.bbox_min,
                                pf.bbox_max, pf.interp, pf.oob)
    close(got_grid.numpy(), ref_grid, 1e-6)
