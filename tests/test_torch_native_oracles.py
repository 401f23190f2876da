"""The port's native CPU oracles against dvren_tpu's, on the CPU.

``dvren_tpu_torch.native`` carries its own copy of the JAX package's
double-precision oracles and packed-ragged views. tests/test_native.py's
cases (raygen pinhole and orthographic, grid evaluation, integration
with aux, the pack / unpack round trip, the PPM bytes) run through both
libraries on the same seeded inputs and must agree bit for bit; the
port's pipeline is held to its own oracles at test_native.py's
tolerances. ``Renderer.packed_samples`` masks on the device; its views
equal JAX's through either of JAX's packing routes (its native core and
its numpy fallback) and the port's native packer on the same lattice.
"""

import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu import native as j_native
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch import native as p_native
from dvren_tpu_torch.io.ppm import write_ppm
from dvren_tpu_torch.ops.grid import eval_grid
from dvren_tpu_torch.ops.integrate import integrate
from dvren_tpu_torch.ops.raygen import generate_rays
from dvren_tpu_torch.ops.sampling import generate_samples

torch.set_num_threads(1)

PINHOLE = (np.array([50.0, 0, 8.0, 0, 45.0, 6.0, 0, 0, 1.0], np.float32),
           np.array([0, -1, 0, 0.2, 1, 0, 0, -0.1, 0, 0, 1, 0.5],
                    np.float32), 1.0, 0)
ORTHO = (np.array([2.0, 0, 8.0, 0, 2.0, 6.0, 0, 0, 1.0], np.float32),
         np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2.0], np.float32),
         0.5, 1)


def test_available_and_the_numpy_route(monkeypatch):
    assert p_native.available() and p_native.load_error() is None
    monkeypatch.setenv("DVREN_NATIVE_SCHED", "0")
    assert not p_native.available()
    assert "DVREN_NATIVE_SCHED=0" in p_native.load_error()


@pytest.mark.parametrize("camera", ["pinhole", "ortho"])
def test_raygen_equals_jax_oracle_and_pipeline(camera):
    k, c2w, scale, model = PINHOLE if camera == "pinhole" else ORTHO
    got = p_native.generate_rays(model, k, c2w, scale, 16, 12,
                                 (0, 0, 16, 12), 0.1, 3.0)
    want = j_native.generate_rays(model, k, c2w, scale, 16, 12,
                                  (0, 0, 16, 12), 0.1, 3.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    plan = P.Plan.create(P.PlanConfig(
        width=16, height=12, t_near=0.1, t_far=3.0,
        camera=P.CameraConfig(
            model=P.CameraModel.ORTHOGRAPHIC if model else
            P.CameraModel.PINHOLE, k=tuple(k), c2w=tuple(c2w),
            ortho_scale=scale),
        sampling=P.SamplingConfig(dt=0.1, max_steps=8)))
    rays = generate_rays(plan, device="cpu")
    np.testing.assert_allclose(rays.origins.numpy(), got[0], atol=1e-6)
    np.testing.assert_allclose(rays.directions.numpy(), got[1], atol=1e-6)
    np.testing.assert_array_equal(rays.pixel_ids.numpy().astype(np.uint32),
                                  got[4])


@pytest.mark.parametrize("interp, oob", [
    (P.InterpMode.LINEAR, P.OobPolicy.ZERO),
    (P.InterpMode.LINEAR, P.OobPolicy.CLAMP),
    (P.InterpMode.NEAREST, P.OobPolicy.ZERO),
    ("color", P.OobPolicy.ZERO)])
def test_grid_eval_equals_jax_oracle_and_pipeline(interp, oob):
    rng = np.random.default_rng(0)
    if interp == "color":
        grid = rng.uniform(0, 1, (4, 4, 4, 3)).astype(np.float32)
        interp = P.InterpMode.LINEAR
    else:
        grid = rng.uniform(0, 1, (5, 6, 7)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, (200, 3)).astype(np.float32)
    got = p_native.eval_grid(grid, (0, 0, 0), (1, 1, 1), int(interp),
                             int(oob), pts)
    want = j_native.eval_grid(grid, (0, 0, 0), (1, 1, 1), int(interp),
                              int(oob), pts)
    np.testing.assert_array_equal(got, want)
    ours = eval_grid(torch.from_numpy(grid), torch.from_numpy(pts),
                     (0, 0, 0), (1, 1, 1), interp, oob).numpy()
    np.testing.assert_allclose(ours, got, rtol=1e-5, atol=1e-6)


def test_integrate_equals_jax_oracle_and_pipeline():
    rng = np.random.default_rng(2)
    n, k = 12, 30
    sigma = rng.uniform(0, 12.0, (n, k)).astype(np.float32)
    color = rng.uniform(0, 1, (n, k, 3)).astype(np.float32)
    dt = np.full((n, k), 0.07, np.float32)
    mask = np.ones((n, k), bool)
    mask[:, 22:] = False
    dt[~mask] = 0.0
    got = p_native.integrate(sigma, color, dt, mask, 0.2, 2.3, want_aux=True)
    want = j_native.integrate(sigma, color, dt, mask, 0.2, 2.3,
                              want_aux=True)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    planes = tuple(torch.from_numpy(np.ascontiguousarray(color[..., c]))
                   for c in range(3))
    ours = integrate(torch.from_numpy(sigma), planes, torch.from_numpy(dt),
                     torch.from_numpy(mask), 0.2, 2.3, with_aux=True)
    np.testing.assert_allclose(ours.radiance.numpy(), got["radiance"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.transmittance.numpy(),
                               got["transmittance"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ours.depth.numpy(), got["depth"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ours.aux.numpy(), got["aux"], rtol=1e-4,
                               atol=1e-6)


def test_pack_unpack_roundtrip_and_offsets():
    plan = P.Plan.create(P.PlanConfig(
        width=4, height=4, t_near=0.0, t_far=1.0,
        sampling=P.SamplingConfig(dt=0.3, max_steps=8)))
    lattice = generate_samples(plan, generate_rays(plan, device="cpu"))
    mask = lattice.mask.numpy()
    offsets = p_native.ray_offsets(mask)
    np.testing.assert_array_equal(offsets, j_native.ray_offsets(mask))
    np.testing.assert_array_equal(
        offsets, lattice.ray_offsets().numpy().astype(np.uint32))
    pos = lattice.positions.numpy()
    packed = p_native.pack_samples(mask, pos)
    np.testing.assert_array_equal(packed, j_native.pack_samples(mask, pos))
    assert packed.shape == (int(mask.sum()), 3)
    np.testing.assert_array_equal(packed[0], pos[0, 0])
    back = p_native.unpack_samples(mask, packed)
    np.testing.assert_array_equal(back, j_native.unpack_samples(mask,
                                                                packed))
    np.testing.assert_array_equal(back[mask], pos[mask])
    assert (back[~mask] == 0).all()
    dt = lattice.dt.numpy()
    np.testing.assert_array_equal(p_native.pack_samples(mask, dt), dt[mask])


def test_ppm_equals_jax_oracle_and_python(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.1, 1.1, (6, 5, 3)).astype(np.float32)
    paths = [tmp_path / f"{name}.ppm" for name in ("port", "jax", "py")]
    p_native.write_ppm(str(paths[0]), img)
    j_native.write_ppm(str(paths[1]), img)
    write_ppm(paths[2], img)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert paths[0].read_bytes() == paths[2].read_bytes()


def packed_scene():
    rng = np.random.default_rng(8)
    n = 6
    plan = J.Plan.create(J.PlanConfig(
        width=10, height=8, t_near=0.1, t_far=2.0, seed=3,
        camera=J.CameraConfig(k=(12.0, 0, 5.0, 0, 12.0, 4.0, 0, 0, 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -0.9)),
        sampling=J.SamplingConfig(dt=0.06, max_steps=32,
                                  mode=J.SamplingMode.STRATIFIED)))
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0.1, 1.0, 3 * n ** 3)))
    return plan, field


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_packed_samples_equal_jax(monkeypatch, route):
    """``route``: how the JAX Renderer packs (its native core, or its
    numpy fallback when the core is not available)."""
    if route == "numpy":
        monkeypatch.setattr(j_native, "available", lambda: False)
    plan, field = packed_scene()
    jr = J.Renderer(J.Context.create(), plan,
                    J.RenderOptions(use_fused_path=True))
    jr.forward(field)
    want = jr.packed_samples()
    pr = P.Renderer(P.Context.create(device="cpu"), port_plan(plan),
                    P.RenderOptions(use_fused_path=True))
    pr.forward(port_field(field))
    got = pr.packed_samples()
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["ray_offset"], want["ray_offset"])
    assert got["ray_offset"].dtype == np.uint32
    for key in ("positions", "dt", "sigma", "color"):
        assert got[key].shape == np.asarray(want[key]).shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=5e-6, rtol=0, err_msg=key)
    lattice = pr._last_outputs.lattice
    mask = lattice.mask.numpy()
    np.testing.assert_array_equal(got["ray_offset"],
                                  p_native.ray_offsets(mask))
    for key, dense in (("positions", lattice.positions), ("dt", lattice.dt)):
        np.testing.assert_array_equal(
            got[key], p_native.pack_samples(mask, dense.numpy()))
