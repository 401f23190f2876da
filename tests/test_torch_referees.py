"""The port held to the contract's own referees, not to the JAX package.

- The integrator (tests/test_integrate.py:65-129): a constant medium
  against T = exp(-sigma L) (1e-5), a piecewise medium and an early stop
  against the float64 sequential oracle (radiance rtol 1e-5, T 1e-5 / 1e-7
  and 1e-4 / 1e-7, depth 1e-4 / 1e-5, aux 1e-4 / 1e-6), a Gaussian
  profile against its erf optical depth (1e-3).
- The gradients (tests/test_backward_fd.py:88-252): K9b's twin
  (``ops.diff.per_sample_grads``) against the float64 reverse adjoint
  recurrence (rtol 1e-4 / atol 1e-6), with and without early
  termination; the voxel-grid and camera gradients against central
  finite differences (eps 1e-3, rel 2e-2; the per-sample referee is
  tests/test_torch_general_paths.py's).
- Determinism and limits (tests/test_determinism_and_limits.py): repeat
  forwards and backwards of the port's Renderer equal byte for byte in
  its fused, tiled and windowed modes; live samples above
  ``plan.max_samples`` refused, exactly at it accepted.
"""

import math

import numpy as np
import pytest
import torch

from tests.test_backward_fd import adjoint_oracle, rel_err
from tests.test_integrate import sequential_oracle

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import diff
from dvren_tpu_torch.ops.integrate import integrate
from dvren_tpu_torch.render import pipeline

CPU = "cpu"


def run(sigma, color, dt, t_far, mask=None, t_near=0.0):
    sigma = torch.as_tensor(np.asarray(sigma, np.float32))
    if mask is None:
        mask = torch.ones(sigma.shape, dtype=torch.bool)
    return integrate(sigma, torch.as_tensor(np.asarray(color, np.float32)),
                     torch.as_tensor(np.asarray(dt, np.float32)),
                     torch.as_tensor(mask), t_near, t_far)


# ----------------------------------------------------------------- integrator


def test_constant_medium_analytic():
    sigma_val, length, steps = 2.0, 1.0, 64
    out = run(np.full((1, steps), sigma_val), np.full((1, steps, 3), 0.7),
              np.full((1, steps), length / steps), t_far=length)
    t_expect = math.exp(-sigma_val * length)
    assert abs(float(out.transmittance[0]) - t_expect) < 1e-5
    np.testing.assert_allclose(out.radiance[0].numpy(),
                               (1 - t_expect) * 0.7, rtol=1e-5)
    assert abs(float(out.opacity[0]) - (1 - t_expect)) < 1e-5


def test_piecewise_vs_sequential_oracle():
    rng = np.random.default_rng(4)
    n, k = 8, 32
    sigma = rng.uniform(0, 5, (n, k)).astype(np.float32)
    sigma[:, k // 2:] *= rng.integers(0, 2, (n, k // 2))
    color = rng.uniform(0, 1, (n, k, 3)).astype(np.float32)
    dt = np.full((n, k), 0.03, np.float32)
    out = run(sigma, color, dt, t_far=0.03 * k)
    rad, trans, depth, _ = sequential_oracle(sigma, color, dt,
                                             t_far=0.03 * k)
    np.testing.assert_allclose(out.radiance.numpy(), rad, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(out.transmittance.numpy(), trans, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(out.depth.numpy(), depth, rtol=1e-4,
                               atol=1e-5)


def test_gaussian_profile_converges():
    steps, length = 512, 1.0
    dt = length / steps
    ts = (np.arange(steps) + 0.5) * dt
    sigma = 10.0 * np.exp(-((ts - 0.5) ** 2) / (2 * 0.1 ** 2))
    out = run(sigma[None], np.ones((1, steps, 3)), np.full((1, steps), dt),
              t_far=length)
    tau = 10.0 * 0.1 * math.sqrt(2 * math.pi)
    assert abs(float(out.transmittance[0]) - math.exp(-tau)) < 1e-3


def test_early_stop_matches_sequential():
    """A saturating medium: the oracle's outputs and aux, and nothing
    past the stop (T after two samples is exp(-10) < 1e-4)."""
    n, k = 2, 40
    sigma = np.full((n, k), 50.0, np.float32)
    color = np.random.default_rng(5).uniform(0, 1, (n, k, 3)).astype(
        np.float32)
    dt = np.full((n, k), 0.1, np.float32)
    out = run(sigma, color, dt, t_far=4.0)
    rad, trans, _, aux = sequential_oracle(sigma, color, dt, t_far=4.0)
    np.testing.assert_allclose(out.radiance.numpy(), rad, rtol=1e-5)
    np.testing.assert_allclose(out.transmittance.numpy(), trans, rtol=1e-4,
                               atol=1e-7)
    got_aux = out.aux.numpy()
    np.testing.assert_allclose(got_aux, aux, rtol=1e-4, atol=1e-6)
    assert np.all(got_aux[:, 3:, :] == 0.0)


# ------------------------------------------------------------------ gradients


@pytest.mark.parametrize("seed,lo,hi,dt,n,k", [
    pytest.param(1, 0.2, 3.0, 0.05, 6, 16, id="plain"),
    pytest.param(7, 2.0, 40.0, 0.1, 4, 24, id="early_stop"),
])
def test_per_sample_grads_match_reference_adjoint(seed, lo, hi, dt, n, k):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(lo, hi, (n, k)).astype(np.float32)
    color = rng.uniform(0, 1, (n, k, 3)).astype(np.float32)
    dts = np.full((n, k), dt, np.float32)
    g = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d_sigma, d_color = diff.per_sample_grads(
        torch.from_numpy(g), torch.from_numpy(sigma),
        torch.from_numpy(color), torch.from_numpy(dts),
        torch.ones((n, k), dtype=torch.bool))
    ds_ref, dc_ref = adjoint_oracle(g, sigma, color, dts)
    np.testing.assert_allclose(d_sigma.numpy(), ds_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(d_color.numpy(), dc_ref, rtol=1e-4, atol=1e-6)


def fd_scene(seed=0):
    """tests/test_backward_fd.py::make_scene on the port: 6x5 rays over a
    random 6^3 grid, 40 fixed steps of 0.06."""
    rng = np.random.default_rng(seed)
    n = 6
    sigma = rng.uniform(0.5, 4.0, (n,) * 3).astype(np.float32)
    color = rng.uniform(0.1, 0.9, (n,) * 3 + (3,)).astype(np.float32)
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(n,) * 3, sigma=sigma.reshape(-1),
        color=color.reshape(-1)), device=CPU)
    plan = P.Plan.create(P.PlanConfig(
        width=6, height=5, t_near=0.3, t_far=2.2,
        camera=P.CameraConfig(
            k=(7.0, 0, 3.0, 0, 7.0, 2.5, 0, 0, 1.0),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=0.06, max_steps=40)))
    return plan, field


def test_voxel_grid_grads_finite_difference():
    """``Renderer.backward``'s grid gradients at the four (sigma) and three
    (colour) largest voxels against central differences of
    <radiance, g> through ``pipeline.render``."""
    plan, field = fd_scene()
    g_img = np.random.default_rng(3).uniform(
        -1, 1, (plan.ray_count, 3)).astype(np.float32)
    r = P.Renderer(P.Context.create(device=CPU), plan)
    r.forward(field)
    br = r.backward(field, g_img)
    d_sigma = br.sigma.reshape(field.sigma.shape)
    d_color = br.color.reshape(field.color.shape)
    assert np.abs(d_sigma).sum() > 0
    g = torch.from_numpy(g_img)
    sig = field.sigma.detach().clone()
    col = field.color.detach().clone()

    def loss_for(s, c):
        with torch.no_grad():
            out = pipeline.render(plan, field.with_params(s, c))
            return float(torch.sum(out.intl.radiance * g))

    eps = 1e-3
    for p in np.argsort(np.abs(d_sigma).reshape(-1))[-4:]:
        idx = np.unravel_index(p, d_sigma.shape)
        e = torch.zeros_like(sig)
        e[idx] = eps
        fd = (loss_for(sig + e, col) - loss_for(sig - e, col)) / (2 * eps)
        assert rel_err(float(d_sigma[idx]), fd) < 2e-2, idx
    for p in np.argsort(np.abs(d_color).reshape(-1))[-3:]:
        idx = np.unravel_index(p, d_color.shape)
        e = torch.zeros_like(col)
        e[idx] = eps
        fd = (loss_for(sig, col + e) - loss_for(sig, col - e)) / (2 * eps)
        assert rel_err(float(d_color[idx]), fd) < 2e-2, idx


def test_camera_grads_finite_difference():
    """``ops.diff.camera_grads``' dL/d(c2w) at three translations and two
    rotation entries against central differences."""
    plan, field = fd_scene(seed=4)
    g = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (plan.ray_count, 3)).astype(np.float32))
    dc2w = diff.camera_grads(plan, field, g)["c2w"].reshape(-1)
    assert float(dc2w.abs().sum()) > 0

    def loss_for(c2w_flat):
        c2w = torch.as_tensor(c2w_flat, dtype=torch.float32).reshape(3, 4)
        with torch.no_grad():
            out = pipeline.render(plan, field, c2w=c2w)
            return float(torch.sum(out.intl.radiance * g))

    base = np.asarray(plan.camera.c2w, np.float64)
    eps = 1e-3
    for idx in (3, 7, 11, 0, 5):
        e = np.zeros(12)
        e[idx] = eps
        fd = (loss_for(base + e) - loss_for(base - e)) / (2 * eps)
        assert rel_err(float(dc2w[idx]), fd) < 2e-2, idx


# ------------------------------------------------------ determinism, limits

MODES = {"fused": dict(), "tiled": dict(use_tiles=True),
         "windowed": dict(use_window=True)}


def limits_scene(max_samples=0):
    """tests/test_determinism_and_limits.py::scene on the port: 8x6 rays,
    30 stratified steps of 0.06 over t in [0.3, 2.1] (every step live),
    a random 6^3 grid."""
    rng = np.random.default_rng(11)
    n = 6
    plan = P.Plan.create(P.PlanConfig(
        width=8, height=6, t_near=0.3, t_far=2.1, seed=2,
        max_samples=max_samples,
        camera=P.CameraConfig(
            k=(9.0, 0, 4.0, 0, 9.0, 3.0, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -0.9)),
        sampling=P.SamplingConfig(dt=0.06, max_steps=30,
                                  mode=P.SamplingMode.STRATIFIED)))
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0.1, 1.0, 3 * n ** 3)), device=CPU)
    return plan, field


def limits_renderer(plan, mode):
    return P.Renderer(P.Context.create(device=CPU), plan,
                      P.RenderOptions(**MODES[mode]))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_backward_determinism_memcmp(mode):
    plan, field = limits_scene()
    dl = np.random.default_rng(3).uniform(
        -1, 1, (plan.ray_count, 3)).astype(np.float32)
    r = limits_renderer(plan, mode)
    r.forward(field)
    a = r.backward(field, dl)
    b = r.backward(field, dl)
    assert np.abs(a.sigma).sum() > 0
    for key in ("sigma", "color", "camera"):
        assert getattr(a, key).tobytes() == getattr(b, key).tobytes(), key


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_determinism_memcmp(mode):
    plan, field = limits_scene()
    r = limits_renderer(plan, mode)
    a = r.forward(field)
    b = r.forward(field)
    assert a.image.std() > 0
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert getattr(a, key).tobytes() == getattr(b, key).tobytes(), key


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sample_capacity_overflow_rejected(mode):
    """48 rays x 30 live steps = 1440 live samples: a cap of 100 or 1439
    is refused."""
    for cap in (100, 1439):
        plan, field = limits_scene(max_samples=cap)
        with pytest.raises(P.DvrenError, match="sample capacity"):
            limits_renderer(plan, mode).forward(field)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_max_samples_at_capacity_ok(mode):
    """A cap of exactly the 1440 live samples, and the default cap
    (max_rays x max_steps, the same number here), are accepted."""
    for cap in (1440, 0):
        plan, field = limits_scene(max_samples=cap)
        assert plan.max_samples == 1440
        fr = limits_renderer(plan, mode).forward(field)
        assert fr.sample_count == 1440
