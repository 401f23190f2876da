"""Override ray bundles and the compose of rays that share pixels, in
dvren_tpu_torch against dvren_tpu, on the CPU.

- ``validate_override``: the JAX package's checks and messages;
- ``compose(unique_pixels=False)`` against JAX's on bundles whose rays
  collide on pixels (up to five a pixel) and drop past the frame: image,
  T, opacity, depth and hitmask equal bit for bit (both reduce each
  pixel's rays in ray order); its gradients against ``jax.grad``: the
  image's a gather, the opacity's and the depth's JAX's, and any gradient
  that reaches the per-ray transmittance refused, as JAX refuses it;
- ``Renderer.forward(field, rays=...)`` on the colliding-pixel and the
  bundle-keyed stratified cases of tests/test_round2_fixes.py:92-175,
  against the JAX Renderer (planes 5e-6, depth 1e-4, hitmask equal),
  and its backward (grid gradients 2e-6 x scale, the camera zero).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.ops.raygen import Rays as JRays
from dvren_tpu.ops.raygen import validate_override as j_validate
from tests.test_round2_fixes import _grid, _small_plan
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import compose as p_compose
from dvren_tpu_torch.ops.raygen import Rays as PRays
from dvren_tpu_torch.ops.raygen import validate_override as p_validate

# dvren_tpu.ops re-exports a function named ``compose``: take the module
j_compose = importlib.import_module("dvren_tpu.ops.compose")

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
GRID_TOL = 2e-6
HEADS = ("image", "transmittance", "opacity", "depth", "hitmask")


def bundle(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.7, (n, 3)).astype(np.float32)
    o[:, 2] = -1.0
    d = rng.normal(0.0, 0.05, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(origins=o, directions=d,
                t_near=np.full(n, 0.1, np.float32),
                t_far=np.full(n, 2.1, np.float32),
                pixel_ids=rng.integers(0, 30, n).astype(np.int32))


def j_rays(b):
    return JRays(**{k: jnp.asarray(v) for k, v in b.items()})


def p_rays(b):
    return PRays(**{k: torch.from_numpy(np.array(v)) for k, v in b.items()})


# ------------------------------------------------------- validate_override

BAD = {
    "origins": dict(origins=np.zeros((4, 2), np.float32)),
    "directions": dict(directions=np.zeros((3, 3), np.float32)),
    "t_near": dict(t_near=np.zeros(3, np.float32)),
    "t_far": dict(t_far=np.zeros((4, 1), np.float32)),
    "pixel_ids": dict(pixel_ids=np.zeros(5, np.int32)),
    "count": None,
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_override_messages_match_jax(case):
    plan = _small_plan()
    if case == "count":
        b = bundle(plan.max_rays + 1)
    else:
        b = dict(bundle(4), **BAD[case])
    with pytest.raises(ValueError) as ref:
        j_validate(plan, j_rays(b))
    with pytest.raises(ValueError) as got:
        p_validate(port_plan(plan), p_rays(b))
    assert str(got.value) == str(ref.value)


def test_validate_override_passes_a_good_bundle():
    plan = port_plan(_small_plan())
    rays = p_rays(bundle(plan.max_rays))
    assert p_validate(plan, rays) is rays


# -------------------------------------------------- the shared-pixel compose

W, H, T_FAR = 7, 5, 3.5


@functools.lru_cache(maxsize=None)
def compose_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 60
    pids = rng.integers(0, 14, n).astype(np.int32)   # up to ~9 rays a pixel
    pids[::11] = W * H + np.arange(len(pids[::11]))  # past the frame
    rad = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tr = rng.uniform(0.05, 1, n).astype(np.float32)
    op = (1.0 - tr).astype(np.float32)
    dep = rng.choice(np.linspace(0.5, 3.0, 9), n).astype(np.float32)  # ties
    return pids, rad, tr, op, dep


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_compose_matches_jax_bit_for_bit(seed):
    args = compose_inputs(seed)
    ref = j_compose.compose(*map(jnp.asarray, args), W, H, T_FAR,
                            unique_pixels=False)
    got = p_compose.compose(*map(torch.from_numpy, args), W, H, T_FAR,
                            unique_pixels=False)
    assert int(np.bincount(args[0][args[0] < W * H]).max()) >= 5
    for name in HEADS:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_shared_compose_of_unique_pixels_equals_the_unique_compose():
    rng = np.random.default_rng(4)
    n = 20
    pids = rng.permutation(W * H)[:n].astype(np.int32)
    vals = [rng.uniform(0, 1, (n, 3)).astype(np.float32)] + [
        rng.uniform(0, 1, n).astype(np.float32) for _ in range(3)]
    t = [torch.from_numpy(x) for x in [pids] + vals]
    a = p_compose.compose(*t, W, H, T_FAR, unique_pixels=False)
    b = p_compose.compose(*t, W, H, T_FAR, unique_pixels=True)
    for name in HEADS:
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), err_msg=name)


def test_shared_compose_of_no_ray_is_background():
    e = torch.zeros(0)
    got = p_compose.compose(torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, 3), e, e, e, W, H, T_FAR,
                            unique_pixels=False)
    assert float(got.image.abs().max()) == 0.0
    assert float(got.transmittance.min()) == 1.0
    assert float(got.depth.min()) == np.float32(T_FAR)
    assert int(got.hitmask.max()) == 0


@pytest.mark.parametrize("head", ["image", "opacity", "depth"])
@pytest.mark.parametrize("arg", [0, 2, 3])
def test_shared_compose_gradients_match_jax(head, arg):
    """The gradient of each head in the per-ray radiance (0), opacity (2)
    and depth (3): ``jax.grad`` of JAX's compose, where it gives one."""
    pids, *vals = compose_inputs(1)
    rng = np.random.default_rng(9)
    shape = (H, W, 3) if head == "image" else (H, W)
    cot = rng.uniform(-1, 1, shape).astype(np.float32)

    def j_loss(x):
        v = [jnp.asarray(a) for a in vals]
        v[arg] = x
        planes = j_compose.compose(jnp.asarray(pids), *v, W, H, T_FAR,
                                   unique_pixels=False)
        return jnp.sum(getattr(planes, head) * cot)

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(vals[arg])))
    leaves = [torch.from_numpy(a.copy()) for a in vals]
    leaves[arg].requires_grad_(True)
    planes = p_compose.compose(torch.from_numpy(pids), *leaves, W, H, T_FAR,
                               unique_pixels=False)
    out = getattr(planes, head)
    if not out.requires_grad:         # the head does not depend on it
        assert np.abs(ref).max() == 0.0
        return
    (got,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)),
                                 leaves[arg], allow_unused=True)
    got = np.zeros_like(ref) if got is None else got.numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("head", ["transmittance", "opacity"])
def test_shared_compose_transmittance_gradient_refused_as_in_jax(head):
    pids, rad, tr, op, dep = compose_inputs(0)

    def j_loss(x):
        planes = j_compose.compose(jnp.asarray(pids), jnp.asarray(rad), x,
                                   jnp.asarray(op), jnp.asarray(dep), W, H,
                                   T_FAR, unique_pixels=False)
        return jnp.sum(getattr(planes, head))

    with pytest.raises(NotImplementedError, match="unique_indices"):
        jax.grad(j_loss)(jnp.asarray(tr))
    leaf = torch.from_numpy(tr.copy()).requires_grad_(True)
    planes = p_compose.compose(torch.from_numpy(pids),
                               torch.from_numpy(rad), leaf,
                               torch.from_numpy(op), torch.from_numpy(dep),
                               W, H, T_FAR, unique_pixels=False)
    with pytest.raises(NotImplementedError, match="unique indices"):
        torch.sum(getattr(planes, head)).backward()


# ------------------------------------------------- Renderer.forward(rays=)

def colliding_bundle():
    """tests/test_round2_fixes.py:92-108: rays 0 and 1 land on pixel 8."""
    o = np.array([[0.5, 0.45, -1.0], [0.62, 0.5, -1.0], [0.4, 0.6, -1.0]],
                 np.float32)
    d = np.array([[0.0, 0.0, 1.0], [-0.05, 0.02, 1.0], [0.1, -0.04, 1.0]],
                 np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.array([8, 8, 14], np.int32)


def override_case(mode):
    plan = _small_plan(mode=mode)
    field = _grid(seed=11)
    o, d, pix = colliding_bundle()
    b = dict(origins=o, directions=d,
             t_near=np.full((3,), plan.t_near, np.float32),
             t_far=np.full((3,), plan.t_far, np.float32), pixel_ids=pix)
    return plan, field, b


def assert_planes_close(got, ref):
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(got.depth, ref.depth, atol=TOL_DEPTH, rtol=0)
    np.testing.assert_array_equal(got.hitmask, ref.hitmask)


@pytest.mark.parametrize("mode", ["fixed", "stratified"])
def test_renderer_override_matches_jax(mode):
    """The colliding-pixel bundle (fixed) and the bundle-keyed stratified
    jitter (tests/test_round2_fixes.py:142-175): forward and backward
    against the JAX Renderer's."""
    plan, field, b = override_case(J.SamplingMode.FIXED if mode == "fixed"
                                   else J.SamplingMode.STRATIFIED)
    jr = J.Renderer(J.Context.create(), plan)
    ref = jr.forward(field, rays=j_rays(b))
    dl = np.random.default_rng(2).uniform(-1, 1, 9).astype(np.float32)
    ref_b = jr.backward(field, dl)
    r = P.Renderer(P.Context.create(device="cpu"), port_plan(plan))
    pf = port_field(field)
    got = r.forward(pf, rays=p_rays(b))
    assert got.ray_count == ref.ray_count == 3
    assert got.sample_count == ref.sample_count
    assert r._last_mode == "override" and "override_path" in got.stats.notes
    assert_planes_close(got, ref)
    got_b = r.backward(pf, dl)
    for key in ("sigma", "color"):
        want = getattr(ref_b, key)
        np.testing.assert_allclose(
            getattr(got_b, key), want, rtol=0,
            atol=GRID_TOL * float(np.abs(want).max()), err_msg=key)
    assert np.all(got_b.camera == 0.0) and np.all(got_b.camera_k == 0.0)
    assert np.abs(got_b.sigma).sum() > 0
    ds, dc = r.per_sample_gradients(dl)
    ref_ds, ref_dc = jr.per_sample_gradients(dl)
    np.testing.assert_allclose(ds, ref_ds, rtol=0,
                               atol=GRID_TOL * float(np.abs(ref_ds).max()))
    np.testing.assert_allclose(dc, ref_dc, rtol=0,
                               atol=GRID_TOL * float(np.abs(ref_dc).max()))
    for key, want in jr.packed_samples().items():
        np.testing.assert_allclose(r.packed_samples()[key], want, rtol=0,
                                   atol=TOL * max(float(np.abs(want).max()),
                                                  1.0), err_msg=key)


def test_override_stratified_jitter_is_keyed_on_the_bundle():
    """Two bundles of one size share the table (keyed on the bundle
    index, not the pixel: JAX's ``rng.jitter_table(seed, n, K)``), and a
    bundle of another size gets a table of its own."""
    from dvren_tpu.ops import rng as j_rng
    plan, field, b = override_case(J.SamplingMode.STRATIFIED)
    r = P.Renderer(P.Context.create(device="cpu"), port_plan(plan))
    pf = port_field(field)
    r.forward(pf, rays=p_rays(b))
    swapped = dict(b, pixel_ids=b["pixel_ids"][::-1].copy())
    r.forward(pf, rays=p_rays(swapped))
    assert list(r._override_jitter) == [3]
    np.testing.assert_array_equal(
        r._override_jitter[3].numpy(),
        j_rng.jitter_table(plan.seed, 3, plan.sampling.max_steps))
    other = bundle(17, seed=3)
    other["t_near"][:] = plan.t_near
    other["t_far"][:] = plan.t_far
    ref = J.Renderer(J.Context.create(), plan).forward(field,
                                                       rays=j_rays(other))
    got = r.forward(pf, rays=p_rays(other))
    assert sorted(r._override_jitter) == [3, 17]
    assert_planes_close(got, ref)


def test_override_refuses_hash_backward_and_bad_bundles():
    plan, field, b = override_case(J.SamplingMode.FIXED)
    r = P.Renderer(P.Context.create(device="cpu"), port_plan(plan))
    with pytest.raises(ValueError, match="pixel_ids must be"):
        r.forward(port_field(field),
                  rays=p_rays(dict(b, pixel_ids=np.zeros(2, np.int32))))
    hf = P.HashMLPField.create(P.HashMLPConfig(), device="cpu")
    r.forward(hf, rays=p_rays(b))
    with pytest.raises(P.DvrenError, match="hash-MLP"):
        r.backward(hf, np.zeros(9, np.float32))
