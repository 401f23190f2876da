"""The contract's structural cases on the port, each held to the contract
itself: the scalar oracle (tests/oracle.py), an analytic value, finite
differences or byte equality; none to the JAX package.

Rays (tests/test_raygen.py): unit directions, counts and pixel ids, the
oracle's pinhole rays (1e-6), the ROI window, override validation, camera
gradients against central differences (rel 2e-2). Sampling
(tests/test_sampling.py): fixed midpoints and monotone t, dt truncated at
t_far, the stratified jitter of ``stratified_jitter_py`` inside each
segment (2e-6), repeat lattices byte-equal. The grid (tests/test_grid.py):
zero and clamp out-of-bounds policies, and both interpolations against
``oracle.trilinear`` (1e-5). Compose (tests/test_compose.py): background,
single rays exact, colliding rays summed / multiplied / min-ed. The
forward (tests/test_forward_oracle.py): every pixel of the smoke scene
against ``oracle.render_forward`` (planes 2e-3, depth 1e-2, the hitmask
equal) in each Renderer mode.
The hash-MLP field (tests/test_hashmlp.py): constant outputs from its
biases, repeat evaluations byte-equal, gradients reaching every parameter
group and agreeing with central differences (rel 2e-2).
"""

import numpy as np
import pytest
import torch

from tests import oracle

import dvren_tpu_torch as P
from dvren_tpu_torch.ops.compose import compose
from dvren_tpu_torch.ops.grid import eval_grid
from dvren_tpu_torch.ops.hashmlp import HashMLPSpec
from dvren_tpu_torch.ops.raygen import Rays, generate_rays, validate_override
from dvren_tpu_torch.ops.rng import stratified_jitter_py
from dvren_tpu_torch.ops.sampling import generate_samples
from dvren_tpu_torch.render import pipeline

CPU = "cpu"


def rays_of(plan, **kw):
    return generate_rays(plan, device=CPU, **kw)


# ----------------------------------------------------------------------- rays


def ray_plan(**kw):
    cfg = dict(width=8, height=6, t_near=0.5, t_far=2.0,
               sampling=P.SamplingConfig(dt=0.1, max_steps=8))
    cfg.update(kw)
    return P.Plan.create(P.PlanConfig(**cfg))


def test_directions_unit_norm():
    norms = torch.linalg.norm(rays_of(ray_plan()).directions, dim=1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-6)


def test_counts_tnear_tfar_pixel_ids():
    rays = rays_of(ray_plan())
    assert rays.count == 48
    np.testing.assert_allclose(rays.t_near.numpy(), 0.5)
    np.testing.assert_allclose(rays.t_far.numpy(), 2.0)
    pids = rays.pixel_ids.numpy()
    assert pids[0] == 0 and pids[-1] == 8 * 6 - 1
    assert len(set(pids.tolist())) == 48


def test_rays_match_scalar_oracle():
    k = (100.0, 0, 4.0, 0, 90.0, 3.0, 0, 0, 1.0)
    c2w = (0.0, -1.0, 0.0, 0.3, 1.0, 0.0, 0.0, -0.2, 0.0, 0.0, 1.0, 0.7)
    rays = rays_of(ray_plan(camera=P.CameraConfig(k=k, c2w=c2w)))
    kmat = np.array(k).reshape(3, 3)
    for py in (0, 3, 5):
        for px in (0, 4, 7):
            o, d = oracle.pinhole_ray(px, py, kmat, c2w)
            np.testing.assert_allclose(rays.origins[py * 8 + px].numpy(), o,
                                       atol=1e-6)
            np.testing.assert_allclose(rays.directions[py * 8 + px].numpy(),
                                       d, atol=1e-6)


def test_roi_window():
    rays = rays_of(ray_plan(roi=P.Roi(x=2, y=1, width=3, height=2)))
    assert rays.count == 6
    np.testing.assert_array_equal(rays.pixel_ids.numpy(),
                                  [10, 11, 12, 18, 19, 20])


def test_override_validation():
    plan = ray_plan()
    n = 5

    def bundle(origins):
        return Rays(origins=origins, directions=torch.ones((n, 3)),
                    t_near=torch.zeros(n), t_far=torch.ones(n),
                    pixel_ids=torch.arange(n, dtype=torch.int32))

    good = bundle(torch.zeros((n, 3)))
    assert validate_override(plan, good) is good
    with pytest.raises(ValueError):
        validate_override(plan, bundle(torch.zeros((n, 2))))


def test_camera_gradients_flow():
    """dL/d(c2w) of sum(d_x^2) through raygen: finite, nonzero, and equal
    to central differences (eps 1e-2) at every entry, within rel 2e-2 plus
    1e-3 (the float32 loss's rounding over 2 eps)."""
    plan = ray_plan()

    def loss(c2w):
        return torch.sum(rays_of(plan, c2w=c2w).directions[:, 0] ** 2)

    c2w0 = torch.tensor(plan.camera.c2w, dtype=torch.float64).reshape(3, 4)
    c2w = c2w0.to(torch.float32).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(c2w), (c2w,))
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    eps = 1e-2
    for idx in range(12):
        e = torch.zeros(12, dtype=torch.float64)
        e[idx] = eps
        e = e.reshape(3, 4)
        with torch.no_grad():
            fd = (float(loss((c2w0 + e).float()))
                  - float(loss((c2w0 - e).float()))) / (2 * eps)
        got = float(g.reshape(-1)[idx])
        assert abs(got - fd) <= 2e-2 * abs(fd) + 1e-3, (idx, got, fd)


# ------------------------------------------------------------------- sampling


def samp_plan(dt=0.1, max_steps=16, mode=P.SamplingMode.FIXED, seed=0,
              t_far=1.0):
    return P.Plan.create(P.PlanConfig(
        width=4, height=4, t_near=0.0, t_far=t_far, seed=seed,
        sampling=P.SamplingConfig(dt=dt, max_steps=max_steps, mode=mode)))


def lattice_of(plan, **kw):
    return generate_samples(plan, rays_of(plan), **kw)


def test_fixed_midpoints_and_monotone_t():
    lat = lattice_of(samp_plan())
    t, mask = lat.t.numpy(), lat.mask.numpy()
    assert mask.sum(axis=1).tolist() == [10] * 16
    np.testing.assert_allclose(t[0][mask[0]], 0.1 * np.arange(10) + 0.05,
                               rtol=1e-6)
    assert np.all(np.diff(t[0][mask[0]]) > 0)


def test_dt_truncated_at_tfar():
    lat = lattice_of(samp_plan(dt=0.3, max_steps=8))
    dt, mask = lat.dt.numpy()[0], lat.mask.numpy()[0]
    assert mask.sum() == 4
    np.testing.assert_allclose(dt[:4], [0.3, 0.3, 0.3, 0.1], rtol=1e-5)
    np.testing.assert_allclose(dt[4:], 0.0)


@pytest.mark.parametrize("route", ["table", "hashed"])
def test_stratified_matches_oracle_and_in_segment(route):
    """Each live sample at base + jitter * dt with the oracle's jitter, in
    its segment; from the host table and hashed on the rays' device."""
    plan = samp_plan(mode=P.SamplingMode.STRATIFIED, seed=99)
    jitter = None
    if route == "table":
        jitter = torch.tensor(pipeline.plan_jitter_table(plan))
    lat = lattice_of(plan, jitter=jitter)
    t, mask = lat.t.numpy(), lat.mask.numpy()
    dt = plan.sampling.dt
    for ray in range(16):
        for step in range(10):
            assert mask[ray, step]
            expect = step * dt + stratified_jitter_py(99, ray, step) * dt
            expect = min(expect, float(np.nextafter(np.float32(1.0),
                                                    np.float32(0.0))))
            assert abs(t[ray, step] - expect) < 2e-6, (ray, step)
            assert step * dt - 1e-6 <= t[ray, step] < (step + 1) * dt + 1e-6


def test_stratified_determinism_memcmp():
    plan = samp_plan(mode=P.SamplingMode.STRATIFIED, seed=7)
    a, b = lattice_of(plan), lattice_of(plan)
    assert a.t.numpy().tobytes() == b.t.numpy().tobytes()
    assert a.positions.numpy().tobytes() == b.positions.numpy().tobytes()


# ----------------------------------------------------------------------- grid


def test_oob_zero_outside_is_zero():
    grid = torch.ones((2, 2, 2))
    pts = torch.tensor([[1.5, 0.5, 0.5], [-0.1, 0.5, 0.5], [0.5, 0.5, 0.5]])
    got = eval_grid(grid, pts, (0, 0, 0), (1, 1, 1), P.InterpMode.LINEAR,
                    P.OobPolicy.ZERO)
    np.testing.assert_allclose(got.numpy(), [0.0, 0.0, 1.0])


def test_oob_clamp_outside_is_edge():
    grid = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (3, 3, 3)).astype(np.float32))
    got = eval_grid(grid, torch.tensor([[2.0, 0.5, 0.5]]), (0, 0, 0),
                    (1, 1, 1), P.InterpMode.LINEAR, P.OobPolicy.CLAMP)
    edge = eval_grid(grid, torch.tensor([[1.0, 0.5, 0.5]]), (0, 0, 0),
                     (1, 1, 1))
    np.testing.assert_allclose(got.numpy(), edge.numpy(), rtol=1e-6)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("oob", ["zero", "clamp"])
def test_grid_matches_oracle_trilinear(interp, oob):
    """Points inside and up to 0.3 outside a (3, 4, 5) box, scalar and
    3-channel grids, against ``oracle.trilinear``."""
    rng = np.random.default_rng(21)
    sigma = rng.uniform(0, 2, (4, 5, 6)).astype(np.float32)
    color = rng.uniform(0, 1, (4, 5, 6, 3)).astype(np.float32)
    lo, hi = (0.5, -1.0, 0.0), (3.5, 3.0, 5.0)
    pts = rng.uniform(np.array(lo) - 0.3, np.array(hi) + 0.3,
                      (64, 3)).astype(np.float32)
    modes = dict(interp=P.InterpMode[interp.upper()],
                 oob=P.OobPolicy[oob.upper()])
    got_s = eval_grid(torch.from_numpy(sigma), torch.from_numpy(pts), lo, hi,
                      **modes).numpy()
    got_c = eval_grid(torch.from_numpy(color), torch.from_numpy(pts), lo, hi,
                      **modes).numpy()
    for i, p in enumerate(pts.astype(np.float64)):
        np.testing.assert_allclose(
            got_s[i], oracle.trilinear(sigma, p, lo, hi, interp, oob),
            atol=1e-5)
        np.testing.assert_allclose(
            got_c[i], oracle.trilinear(color, p, lo, hi, interp, oob),
            atol=1e-5)


# -------------------------------------------------------------------- compose


def test_unique_pixels_scatter():
    n = 5
    trans = torch.tensor([0.1, 0.2, 0.3, 0.4, 0.5])
    out = compose(torch.tensor([0, 3, 5, 7, 11], dtype=torch.int32),
                  torch.arange(n * 3, dtype=torch.float32).reshape(n, 3),
                  trans, 1.0 - trans, torch.tensor([1.0, 2, 3, 4, 5]), 4, 3,
                  t_far=9.0)
    img = out.image.reshape(-1, 3).numpy()
    np.testing.assert_allclose(img[3], [3, 4, 5])
    np.testing.assert_allclose(img[1], 0.0)
    t = out.transmittance.reshape(-1).numpy()
    assert t[1] == 1.0 and abs(t[0] - 0.1) < 1e-7
    o = out.opacity.reshape(-1).numpy()
    assert o[1] == 0.0 and abs(o[5] - 0.7) < 1e-6
    d = out.depth.reshape(-1).numpy()
    assert d[1] == 9.0 and d[7] == 4.0
    np.testing.assert_array_equal(out.hitmask.reshape(-1).numpy(),
                                  [1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 1])


def test_colliding_rays_accumulate():
    """Rays on one pixel: the image sums, T multiplies, depth takes the
    minimum (img_cpu.cpp:177-184)."""
    trans = torch.tensor([0.5, 0.5, 0.8])
    out = compose(torch.tensor([2, 2, 2], dtype=torch.int32),
                  torch.tensor([[0.1, 0, 0], [0.2, 0, 0], [0.3, 0, 0]]),
                  trans, 1.0 - trans, torch.tensor([3.0, 2.0, 4.0]), 4, 1,
                  t_far=9.0, unique_pixels=False)
    np.testing.assert_allclose(out.image.reshape(-1, 3)[2].numpy(),
                               [0.6, 0, 0], rtol=1e-6)
    assert abs(float(out.transmittance.reshape(-1)[2]) - 0.2) < 1e-6
    assert abs(float(out.opacity.reshape(-1)[2]) - 0.8) < 1e-6
    assert float(out.depth.reshape(-1)[2]) == 2.0


def test_roi_background_planes():
    w, h = 8, 6
    pids = torch.tensor([y * w + x for y in (2, 3) for x in (1, 2)],
                        dtype=torch.int32)
    n = int(pids.numel())
    out = compose(pids, torch.full((n, 3), 0.25), torch.full((n,), 0.5),
                  torch.full((n,), 0.5), torch.full((n,), 1.5), w, h,
                  t_far=7.0)
    assert int(out.hitmask.sum()) == 4
    assert out.transmittance[0, 0] == 1.0 and out.transmittance[2, 1] == 0.5
    assert out.depth[0, 0] == 7.0 and out.depth[3, 2] == 1.5


# -------------------------------------------------------------------- forward

SMOKE_W, SMOKE_H = 12, 10
FORWARD_MODES = {"fused": dict(), "staged": dict(use_fused_path=False),
                 "streamed": dict(streaming=True),
                 "tiled": dict(use_tiles=True),
                 "windowed": dict(use_window=True)}


def smoke_volume(n=10):
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.4) ** 2
    sigma = 8.0 * np.exp(-r2 / 0.08).astype(np.float32)
    color = np.stack([xs, ys, 1.0 - zs], axis=-1).astype(np.float32)
    return sigma, color


def smoke_plan():
    return P.Plan.create(P.PlanConfig(
        width=SMOKE_W, height=SMOKE_H, t_near=0.4, t_far=2.4,
        camera=P.CameraConfig(k=(14.0, 0, 6.0, 0, 14.0, 5.0, 0, 0, 1.0),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -1.2)),
        sampling=P.SamplingConfig(dt=0.05, max_steps=48)))


def smoke_forward(**options):
    sigma, color = smoke_volume()
    n = sigma.shape[0]
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.reshape(-1),
        color=color.reshape(-1)), device=CPU)
    plan = smoke_plan()
    r = P.Renderer(P.Context.create(device=CPU), plan,
                   P.RenderOptions(**options))
    return plan, sigma, color, r.forward(field)


@pytest.mark.parametrize("mode", sorted(FORWARD_MODES))
def test_smoke_forward_matches_oracle(mode):
    plan, sigma, color, fr = smoke_forward(**FORWARD_MODES[mode])
    exp = oracle.render_forward(
        plan.width, plan.height, np.asarray(plan.camera.k).reshape(3, 3),
        plan.camera.c2w, plan.t_near, plan.t_far, plan.sampling.dt,
        plan.sampling.max_steps, sigma, color)
    hw = (SMOKE_H, SMOKE_W)
    img = fr.image.reshape(hw + (3,))
    assert np.abs(img - exp["image"]).max() < 2e-3
    assert np.abs(fr.transmittance.reshape(hw)
                  - exp["transmittance"]).max() < 2e-3
    assert np.abs(fr.opacity.reshape(hw) - exp["opacity"]).max() < 2e-3
    assert np.abs(fr.depth.reshape(hw) - exp["depth"]).max() < 1e-2
    np.testing.assert_array_equal(fr.hitmask.reshape(hw), exp["hitmask"])
    assert img.std() > 1e-3 and fr.opacity.max() > 0.5


# ------------------------------------------------------------------- hash-MLP

SPEC = HashMLPSpec()


def bias_blob(sigma_bias, color_bias):
    """All-zero parameters except the output biases: constant outputs."""
    flat = np.zeros(SPEC.param_count, np.float32)
    off = SPEC.hash_table_size + SPEC.sigma_weights_size
    flat[off + SPEC.hidden_dim] = sigma_bias
    off2 = off + SPEC.sigma_biases_size + SPEC.color_weights_size
    flat[off2 + SPEC.hidden_dim: off2 + SPEC.hidden_dim + 3] = color_bias
    return flat


def hash_field(flat):
    return P.HashMLPField.create(P.HashMLPConfig(params=flat), device=CPU)


def points(seed, n):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (n, 3)).astype(np.float32))


def test_hash_constant_bias_outputs():
    field = hash_field(bias_blob(1.25, (0.25, 0.5, 0.75)))
    pts = points(0, 32)
    np.testing.assert_allclose(field.sigma_at(pts).detach().numpy(), 1.25,
                               rtol=1e-6)
    np.testing.assert_allclose(
        field.color_at(pts).detach().numpy(),
        np.broadcast_to([0.25, 0.5, 0.75], (32, 3)), rtol=1e-6)
    clamped = hash_field(bias_blob(-2.0, (-1.0, 2.0, 0.5)))
    one = torch.tensor([[0.3, 0.4, 0.5]])
    assert float(clamped.sigma_at(one)[0].detach()) == 0.0
    np.testing.assert_allclose(clamped.color_at(one)[0].detach().numpy(),
                               [0.0, 1.0, 0.5])


def test_hash_determinism_memcmp():
    rng = np.random.default_rng(3)
    field = hash_field(rng.uniform(-0.5, 0.5, SPEC.param_count).astype(
        np.float32))
    pts = torch.from_numpy(rng.uniform(0, 1, (64, 3)).astype(np.float32))
    with torch.no_grad():
        for fn in (field.sigma_at, field.color_at):
            assert fn(pts).numpy().tobytes() == fn(pts).numpy().tobytes()


def test_hash_gradients_flow_to_all_param_groups():
    """sum(sigma^2) + sum(color^2) at 32 points: gradients finite, nonzero
    on the table and both first layers, and in each parameter group the
    entry of largest gradient equal to a central difference (eps 1e-3,
    rel 2e-2: float32 differences, as for the voxel grid)."""
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                       device=CPU)
    pts = points(5, 32)
    keys = sorted(field.params)
    base = {k: v.detach().clone() for k, v in field.params.items()}

    def loss(params):
        f = field.with_params(params)
        return torch.sum(f.sigma_at(pts) ** 2) + torch.sum(f.color_at(pts) ** 2)

    f0 = field.with_params(base)
    grads = dict(zip(keys, torch.autograd.grad(
        loss(dict(f0.params)), [f0.params[k] for k in keys])))
    for g in grads.values():
        assert torch.isfinite(g).all()
    for k in ("hash_table", "sigma_w1", "color_w1"):
        assert float(grads[k].abs().sum()) > 0, k
    eps = 1e-3
    for k in keys:
        i = int(grads[k].abs().reshape(-1).argmax())
        got = float(grads[k].reshape(-1)[i])
        if got == 0.0:
            continue
        e = torch.zeros(base[k].numel())
        e[i] = eps
        e = e.reshape(base[k].shape)
        with torch.no_grad():
            fd = (float(loss({**base, k: base[k] + e}))
                  - float(loss({**base, k: base[k] - e}))) / (2 * eps)
        assert abs(got - fd) <= 2e-2 * max(abs(got), abs(fd)), (k, got, fd)
