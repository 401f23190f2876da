"""The scene suites on the port: tests/test_scenes.py for dvren_tpu_torch.

The high-res subset, the SDF shell's structure and the animation frames
are held to the independent scalar oracle (tests/oracle.py) at the JAX
suite's tolerances: image 3e-3 (4e-3 on the animation), depth 1e-2 except
on pixels whose opacity sits at the depth rule's knife edge
(``OPACITY_EPS``). Pose refinement runs on the port's camera gradients:
``pipeline.render(c2w=...)`` and ``render_tiled(..., k=, c2w=)`` under
``torch.optim.Adam``, with the JAX tests' convergence assertions. All on
the CPU, through the kernels' plain twins.
"""

import dataclasses

import numpy as np
import torch

from tests import oracle

import dvren_tpu_torch as P
from dvren_tpu_torch.ops.integrate import OPACITY_EPS
from dvren_tpu_torch.render import pipeline, tiled
from dvren_tpu_torch.utils.scenes import (blob_color, dense_field,
                                          grid_coords, make_plan,
                                          sphere_shell_volume)

CPU = "cpu"


def subset_oracle_check(plan, fr, sigma, color, pixels, img_tol=3e-3,
                        depth_tol=1e-2):
    """Each pixel of ``pixels`` against ``oracle.integrate_pixel``.

    Depth is defined discontinuously at ``OPACITY_EPS`` (below it depth
    snaps to t_far), so on a pixel whose oracle opacity lies within
    4 * OPACITY_EPS of it two correct integrators may take different
    branches: its depth is not compared. ``fr`` has flat ``image`` and
    ``depth`` arrays (a ForwardResult) or (H, W, ...) tensors."""
    K = np.asarray(plan.camera.k).reshape(3, 3)
    img = np.asarray(torch.as_tensor(fr.image).detach().cpu()).reshape(
        plan.height, plan.width, 3)
    dep = np.asarray(torch.as_tensor(fr.depth).detach().cpu()).reshape(
        plan.height, plan.width)
    for (px, py) in pixels:
        o, d = oracle.pinhole_ray(px, py, K, plan.camera.c2w)
        exp = oracle.integrate_pixel(
            o, d, plan.t_near, plan.t_far, plan.sampling.dt,
            plan.sampling.max_steps, sigma, color, (0, 0, 0), (1, 1, 1))
        assert np.abs(img[py, px] - exp["radiance"]).max() < img_tol, (px, py)
        knife_edge = abs(exp["opacity"] - OPACITY_EPS) < 4 * OPACITY_EPS
        assert knife_edge or \
            abs(dep[py, px] - exp["depth"]) < depth_tol, (px, py)


def renderer(plan, **options):
    return P.Renderer(P.Context.create(device=CPU), plan,
                      P.RenderOptions(**options))


def test_highres_subset_oracle():
    """96x72 over a 20^3 shell (the JAX suite's size): finite, varied,
    every pixel a ray, 12 pixels against the oracle; the tiled path and
    the default path each."""
    sigma, color = sphere_shell_volume(20, radius=0.3, width=0.06)
    plan = make_plan(96, 72)
    field = dense_field(sigma, color, CPU)
    rng = np.random.default_rng(0)
    pixels = list(zip(rng.integers(0, 96, 12), rng.integers(0, 72, 12)))
    for options in (dict(), dict(use_tiles=True)):
        fr = renderer(plan, **options).forward(field)
        img = fr.image.reshape(72, 96, 3)
        assert np.isfinite(img).all()
        assert img.std() > 0.01
        assert fr.hitmask.sum() == 96 * 72
        subset_oracle_check(plan, fr, sigma, color, pixels)


def test_sdf_sphere_shell_structure():
    """The limb brighter than the translucent centre, >= 10 % of pixels
    active, and 8 pixels against the oracle."""
    sigma, color = sphere_shell_volume(32, radius=0.35, width=0.015)
    sigma *= 0.3
    plan = make_plan(64, 64, focal_scale=1.6)
    fr = renderer(plan).forward(dense_field(sigma, color, CPU))
    opacity = fr.opacity.reshape(64, 64)
    center = opacity[30:34, 30:34].mean()
    ring = np.concatenate([opacity[32, 6:12], opacity[32, 52:58]])
    assert ring.mean() > center + 0.05
    assert (opacity > 0.05).mean() >= 0.10
    rng = np.random.default_rng(1)
    pixels = list(zip(rng.integers(16, 48, 8), rng.integers(16, 48, 8)))
    subset_oracle_check(plan, fr, sigma, color, pixels)


def animation_volume(n, t):
    """The 12-frame suite's blob at time t, float32 numpy."""
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r2 = (xs - (0.35 + 0.3 * t)) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (9.0 * np.exp(-r2 / 0.05)).astype(np.float32)
    color = blob_color(grid_coords(n, CPU)).numpy()
    return sigma, color


def test_animation_frames():
    """12 frames through one Renderer, the field made anew each frame:
    finite, opacity <= 1, T >= 0, frames 0, 6 and 11 against the oracle
    (image 4e-3), and every frame differs from the one before."""
    plan = make_plan(16, 12, dt=0.0625, max_steps=32)
    r = renderer(plan)
    n = 10
    prev_img = None
    rng_pix = np.random.default_rng(2)
    for frame in range(12):
        sigma, color = animation_volume(n, frame / 12.0)
        fr = r.forward(dense_field(sigma, color, CPU))
        img = fr.image.reshape(12, 16, 3)
        assert np.isfinite(img).all()
        assert fr.opacity.max() <= 1.0 + 1e-6
        assert fr.transmittance.min() >= -1e-6
        if frame in (0, 6, 11):
            pixels = list(zip(rng_pix.integers(0, 16, 5),
                              rng_pix.integers(0, 12, 5)))
            subset_oracle_check(plan, fr, sigma, color, pixels, img_tol=4e-3)
        if prev_img is not None:
            assert np.abs(img - prev_img).max() > 1e-5
        prev_img = img


def pose_scene(w, h):
    sigma, color = sphere_shell_volume(12, radius=0.3, width=0.08)
    plan = make_plan(w, h, dt=0.0625, max_steps=32)
    field = dense_field(sigma, color, CPU).requires_grad_(False)
    true_c2w = torch.tensor(plan.camera.c2w, dtype=torch.float32).reshape(
        3, 4)
    return plan, field, true_c2w


def with_translation(c2w, t):
    return torch.cat([c2w[:, :3], t[:, None]], dim=1)


def test_pose_refinement_converges():
    """The translation of c2w recovered through ``pipeline.render``'s
    camera gradients: 80 Adam steps at lr 1e-2 from an offset of
    (0.06, -0.05, 0) bring the loss below 0.2 x its start and halve the
    error."""
    plan, field, true_c2w = pose_scene(20, 16)
    target = pipeline.render(plan, field, c2w=true_c2w).planes.image
    t_true = true_c2w[:, 3]
    t0 = t_true + torch.tensor([0.06, -0.05, 0.0])
    t = t0.clone().requires_grad_(True)
    opt = torch.optim.Adam([t], lr=1e-2)

    def loss_at(tv):
        img = pipeline.render(plan, field,
                              c2w=with_translation(true_c2w, tv)).planes.image
        return torch.mean((img - target) ** 2)

    with torch.no_grad():
        l0 = float(loss_at(t0))
    for _ in range(80):
        opt.zero_grad()
        loss = loss_at(t)
        loss.backward()
        opt.step()
    with torch.no_grad():
        l_end = float(loss_at(t))
    loss = float(loss.detach())
    err0 = float((t0 - t_true).abs().max())
    err1 = float((t.detach() - t_true).abs().max())
    assert loss < l0 * 0.2 and l_end < l0 * 0.2, (loss, l0)
    assert err1 < err0 * 0.5, (err1, err0)


def test_pose_refinement_converges_tiled():
    """The same through ``render_tiled(..., k=, c2w=)``: the camera
    gradients of K2's twin, the schedule rebuilt at the current estimate
    every 10 of 60 steps (it bakes the camera); loss below half its
    start, the error halved."""
    plan, field, true_c2w = pose_scene(32, 32)
    k0 = torch.tensor(plan.camera.k, dtype=torch.float32).reshape(3, 3)
    sched0 = tiled.build_tiled_schedule(plan, field).to(CPU)
    target = tiled.render_tiled(plan, field, sched0, k=k0,
                                c2w=true_c2w).image.detach()
    t_true = true_c2w[:, 3]
    t0 = t_true + torch.tensor([0.05, -0.04, 0.0])
    t = t0.clone().requires_grad_(True)
    opt = torch.optim.Adam([t], lr=1e-2)
    l0 = None
    for it in range(60):
        if it % 10 == 0:
            c2w_now = with_translation(true_c2w, t.detach())
            cam = dataclasses.replace(
                plan.camera, c2w=tuple(c2w_now.reshape(-1).tolist()))
            sched = tiled.build_tiled_schedule(plan.with_camera(cam),
                                               field).to(CPU)
        opt.zero_grad()
        img = tiled.render_tiled(plan, field, sched, k=k0,
                                 c2w=with_translation(true_c2w, t)).image
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        loss = float(loss.detach())
        if l0 is None:
            l0 = loss
        opt.step()
    err0 = float((t0 - t_true).abs().max())
    err1 = float((t.detach() - t_true).abs().max())
    assert loss < l0 * 0.5, (loss, l0)
    assert err1 < err0 * 0.5, (err1, err0)
