"""The supercell and hash-tiled contract cases on the port, each held to a
referee inside the port or to the scalar oracle, never to the JAX package.

Supercells (tests/test_supercell.py): on the coarse-view scene (a 32^3
blob at 48^2, 32 stratified steps: ~1.5 px a cell, where 16 px cell
tables overflow), ``render_tiled`` over the ``cell_scale=2`` schedule
(K1's twin, the 108-column table) reproduces the windowed render
(``render_windowed_traced``: the per-ray path over K9's twin) within
2e-6, matches ``oracle.integrate_pixel`` with the stratified jitter of
``stratified_jitter_py`` on 24 pixels (image 2e-3, depth 1e-2 off the
knife edge), and its field and camera gradients (K2's twin) match the
windowed path's autograd (1e-5 and 5e-3 x scale).

Hash-MLP tiles (tests/test_hash_tiled.py): ``render_hash_tiled`` (K7f's
twin) equals ``pipeline.render`` of the same field (planes 5e-6, depth
1e-4, the hitmask equal), fixed and stratified, and its parameter
gradients through K7b's twin equal autograd through ``pipeline.render``
(2e-5 x scale per parameter group). The hash grid's frame and gradients
(K8f / K8b's twins) repeat byte for byte. An explicit ``use_window=True``
keeps the windowed path where the default would take the tiles.
"""

import functools
import types

import numpy as np
import pytest
import torch

from tests import oracle

import dvren_tpu_torch as P
from dvren_tpu_torch.ops.hashmlp import HashMLPSpec
from dvren_tpu_torch.ops.integrate import OPACITY_EPS
from dvren_tpu_torch.ops.rng import stratified_jitter_py
from dvren_tpu_torch.render import hash_tiled, pipeline, tiled, windowed

CPU = "cpu"


# ----------------------------------------------------------------- supercells


@functools.lru_cache(maxsize=None)
def super_scene(n=32, wh=48, steps=32):
    zs, ys, xs = np.meshgrid(*[np.linspace(0, 1, n)] * 3, indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (12.0 * np.exp(-r2 / 0.05)).astype(np.float32)
    color = np.stack([xs, ys, 1.0 - zs], -1).astype(np.float32)
    plan = P.Plan.create(P.PlanConfig(
        width=wh, height=wh, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(
            k=(wh * 1.2, 0, wh / 2, 0, wh * 1.2, wh / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=P.SamplingMode.STRATIFIED)))
    jit = pipeline.plan_jitter_table(plan)
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(n,) * 3, sigma=sigma.reshape(-1),
        color=color.reshape(-1)), device=CPU)
    s2 = tiled.build_tiled_schedule(plan, field, jitter=jit, cell_scale=2)
    assert s2.groups and s2.fallback_rays < s2.total_rays
    wsched = windowed.build_schedule(plan, field.bbox_min, field.bbox_max,
                                     jitter=jit, device=CPU)
    return plan, field, s2.to(CPU), wsched, sigma, color


def fresh_field(field):
    return field.with_params(field.sigma.detach().clone(),
                             field.color.detach().clone())


def test_supercell_reference_matches_windowed():
    plan, field, s2, wsched, _, _ = super_scene()
    with torch.no_grad():
        ref = windowed.render_windowed_traced(plan, field, wsched)
        out = tiled.render_tiled(plan, field, s2)
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   getattr(ref, key).numpy(), atol=2e-6,
                                   err_msg=key)
    np.testing.assert_array_equal(out.hitmask.numpy(), ref.hitmask.numpy())


def test_supercell_kernel_matches_oracle():
    plan, field, s2, _, sigma, color = super_scene()
    with torch.no_grad():
        out = tiled.render_tiled(plan, field, s2)
    img, dep = out.image.numpy(), out.depth.numpy()
    kmat = np.asarray(plan.camera.k).reshape(3, 3)
    rng = np.random.default_rng(4)
    for px, py in zip(rng.integers(0, 48, 24), rng.integers(0, 48, 24)):
        ray = int(py) * plan.width + int(px)
        o, d = oracle.pinhole_ray(px, py, kmat, plan.camera.c2w)
        exp = oracle.integrate_pixel(
            o, d, plan.t_near, plan.t_far, plan.sampling.dt,
            plan.sampling.max_steps, sigma, color, (0, 0, 0), (1, 1, 1),
            jitter_fn=lambda s, r=ray: stratified_jitter_py(plan.seed, r, s))
        assert np.abs(img[py, px] - exp["radiance"]).max() < 2e-3, (px, py)
        knife_edge = abs(exp["opacity"] - OPACITY_EPS) < 4 * OPACITY_EPS
        assert knife_edge or abs(dep[py, px] - exp["depth"]) < 1e-2, (px, py)


def test_supercell_gradients_match_windowed():
    plan, field, s2, wsched, _, _ = super_scene()
    grads = []
    for render in (lambda f: tiled.render_tiled(plan, f, s2),
                   lambda f: windowed.render_windowed_traced(plan, f,
                                                             wsched)):
        f = fresh_field(field)
        torch.mean(render(f).image ** 2).backward()
        grads.append((f.sigma.grad, f.color.grad))
    for got, ref in zip(*grads):
        scale = max(float(ref.abs().max()), 1e-12)
        assert float((got - ref).abs().max()) / scale < 1e-5


def test_supercell_camera_gradients_match_windowed():
    plan, field, s2, wsched, _, _ = super_scene()
    field = fresh_field(field).requires_grad_(False)
    k0 = torch.tensor(plan.camera.k, dtype=torch.float32).reshape(3, 3)
    dl = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, (plan.height, plan.width, 3)).astype(np.float32))
    grads = []
    for render in (
            lambda c: tiled.render_tiled(plan, field, s2, k=k0, c2w=c),
            lambda c: windowed.render_windowed_traced(plan, field, wsched,
                                                      k=k0, c2w=c)):
        c2w = torch.tensor(plan.camera.c2w, dtype=torch.float32).reshape(
            3, 4).requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(render(c2w).image * dl), (c2w,))
        grads.append(g)
    got, ref = grads
    assert float(got.abs().sum()) > 0
    assert float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-9) < 5e-3


# ------------------------------------------------------------ hash-MLP tiles

SPEC = HashMLPSpec()


def hash_field(seed):
    rng = np.random.default_rng(seed)
    return P.HashMLPField.create(P.HashMLPConfig(params=rng.uniform(
        -0.5, 0.5, SPEC.param_count).astype(np.float32)), device=CPU)


def hash_plan(w=24, h=20, mode=P.SamplingMode.FIXED, seed=0):
    return P.Plan.create(P.PlanConfig(
        width=w, height=h, t_near=0.2, t_far=1.8, seed=seed,
        sampling=P.SamplingConfig(dt=0.05, max_steps=24, mode=mode)))


@pytest.mark.parametrize("seed,mode,plan_seed", [
    pytest.param(0, P.SamplingMode.FIXED, 0, id="fixed"),
    pytest.param(5, P.SamplingMode.STRATIFIED, 11, id="stratified"),
])
def test_hash_tiled_forward_matches_pipeline(seed, mode, plan_seed):
    f = hash_field(seed)
    plan = hash_plan(mode=mode, seed=plan_seed)
    with torch.no_grad():
        out = hash_tiled.render_hash_tiled(
            plan, f, hash_tiled.build_hash_schedule(plan, device=CPU))
        ref = pipeline.render(plan, f).planes
    for key in ("image", "opacity", "transmittance"):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   getattr(ref, key).numpy(), atol=5e-6,
                                   err_msg=key)
    np.testing.assert_allclose(out.depth.numpy(), ref.depth.numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(out.hitmask.numpy(), ref.hitmask.numpy())


def test_hash_tiled_gradients_match_pipeline():
    f = hash_field(2)
    plan = hash_plan(w=16, h=16, mode=P.SamplingMode.STRATIFIED, seed=3)
    sched = hash_tiled.build_hash_schedule(plan, device=CPU)
    tgt = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (16, 16, 3)).astype(np.float32))
    keys = sorted(f.params)
    grads = []
    for render in (lambda g: hash_tiled.render_hash_tiled(plan, g, sched),
                   lambda g: pipeline.render(plan, g).planes):
        g = f.with_params({k: v.detach().clone()
                           for k, v in f.params.items()})
        torch.mean((render(g).image - tgt) ** 2).backward()
        grads.append({k: g.params[k].grad for k in keys})
    got, ref = grads
    for k in keys:
        scale = max(float(ref[k].abs().max()), 1e-8)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=2e-5 * scale, err_msg=k)


def test_explicit_use_window_beats_auto_tiles():
    """On a CUDA context the default takes the tiles; an explicit
    ``use_window=True`` keeps the windowed path (whose camera gradients
    are not baked into a schedule), and an explicit ``use_tiles=True``
    still wins over it. The CPU render of that option is windowed."""
    plan, field, _, _, _, _ = super_scene()
    cuda_ctx = types.SimpleNamespace(device=torch.device("cuda", 0))

    def mode(**options):
        return P.Renderer(cuda_ctx, plan, P.RenderOptions(**options))._mode(
            field, None)

    assert mode() == "tiled"
    assert mode(use_window=True) == "windowed"
    assert mode(use_window=True, use_tiles=True) == "tiled"
    fr = P.Renderer(P.Context.create(device=CPU), plan,
                    P.RenderOptions(use_window=True)).forward(field)
    assert "windowed_path" in " ".join(fr.stats.notes)


# ------------------------------------------------------------ hash-grid tiles


def test_hash_grid_determinism():
    """``render_hash_grid_tiled`` (K8f's twin) twice: the frame equal byte
    for byte; its parameter gradients (K8b's twin) too."""
    spec = HashMLPSpec(n_levels=3, features_per_level=2, table_size=4096,
                       hidden_dim=8, base_resolution=2.0,
                       finest_resolution=8.0, resolutions=(2, 4, 8))
    plan = P.Plan.create(P.PlanConfig(
        width=32, height=32, t_near=0.2, t_far=2.2, seed=6,
        camera=P.CameraConfig(k=(38.4, 0, 16, 0, 38.4, 16, 0, 0, 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / 16, max_steps=16,
                                  mode=P.SamplingMode.STRATIFIED)))
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(6),
                                       spec=spec, table_std=0.5, device=CPU)
    sched = hash_tiled.build_hash_grid_schedule(plan, field, device=CPU)
    runs = []
    for _ in range(2):
        f = field.with_params({k: v.detach().clone()
                               for k, v in field.params.items()})
        image = hash_tiled.render_hash_grid_tiled(plan, f, sched).image
        torch.mean(image ** 2).backward()
        runs.append([image.detach()] + [f.params[k].grad
                                        for k in sorted(f.params)])
    assert float(runs[0][0].std()) > 0
    for a, b in zip(*runs):
        assert a.numpy().tobytes() == b.numpy().tobytes()
