"""The port's per-ray integrator against dvren_tpu, on the CPU.

``dvren_tpu_torch.ops.integrate.integrate`` (K9f's plain twin) and
``ops.integrate_fused`` (the autograd node; on CPU tensors K9f / K9b run
their twins) against ``dvren_tpu/ops/integrate.py::integrate`` and
``integrate_pallas`` in interpret mode, on tests/test_pallas_parity.py's
lattices (40 x 50, with and without saturation; 16 x 200), at that
file's bounds: radiance rtol 1e-5 / atol 1e-6, T and opacity rtol 1e-5 /
atol 1e-7, depth rtol 1e-5 / atol 1e-5 (rtol 1e-4 at K >= 128), d_sigma
rtol 1e-4 / atol 1e-6, d_colour rtol 1e-4 / atol 1e-7. The aux planes
are held at the radiance bound (log T_before: rtol 1e-5 / atol 1e-5).

The tie convention: on a lattice with exact-zero sigma the port's d_sigma
equals ``jax.grad`` of ``integrate`` (0.5 at sigma*dt == 0) and is half
of ``integrate_pallas``'s at those samples only (it multiplies by
``sigma*dt >= 0``). The T and opacity gradients follow the fused tile
kernels (``-T`` on every processed step); ``jnp.min`` splits them over
tied prefixes, so they are compared with JAX's on fields without exact
zeros only. tests/test_torch_cuda.py holds K9f / K9b to these twins on
the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvren_tpu.ops.integrate_pallas import _bwd_call, integrate_pallas

from dvren_tpu_torch.ops import integrate as p_int
from dvren_tpu_torch.ops import integrate_fused as p_fused

# dvren_tpu.ops re-exports a function named ``integrate``: take the module
j_int = importlib.import_module("dvren_tpu.ops.integrate")

torch.set_num_threads(1)

T_NEAR, T_FAR = 0.3, 2.8


def lattice(n=40, k=50, seed=0, saturating=False, zeros=False):
    """tests/test_pallas_parity.py::scene as numpy, with an optional third
    of sigma set to exactly zero, a per-ray depth origin and a radiance
    cotangent."""
    rng = np.random.default_rng(seed)
    hi = 40.0 if saturating else 4.0
    sigma = rng.uniform(0.0, hi, (n, k)).astype(np.float32)
    color = rng.uniform(0, 1, (n, k, 3)).astype(np.float32)
    dt = np.full((n, k), 0.05, np.float32)
    mask = np.ones((n, k), bool)
    for i, length in enumerate(rng.integers(k // 2, k + 1, n)):
        mask[i, length:] = False
        dt[i, length:] = 0.0
    if zeros:
        sigma[rng.uniform(size=(n, k)) < 0.3] = 0.0
    origin = (T_NEAR + rng.integers(0, 6, n) * 0.05).astype(np.float32)
    g = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return sigma, color, dt, mask, origin, g


def port(sigma, color, dt, mask):
    t = torch.from_numpy
    c = t(color)
    return t(sigma), (c[..., 0], c[..., 1], c[..., 2]), t(dt), t(mask)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def assert_heads(got, ref, depth_rtol=1e-5):
    close(got[0], ref.radiance, 1e-5, 1e-6)
    close(got[1], ref.transmittance, 1e-5, 1e-7)
    close(got[2], ref.opacity, 1e-5, 1e-7)
    close(got[3], ref.depth, depth_rtol, 1e-5)


CASES = {"plain": dict(), "saturating": dict(saturating=True),
         "large_k": dict(n=16, k=200, seed=3)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("with_origin", [False, True])
def test_integrate_matches_reference(case, with_origin):
    sigma, color, dt, mask, origin, _ = lattice(**CASES[case])
    ref = jax.jit(lambda *a: j_int.integrate(*a[:4], T_NEAR, T_FAR,
                                             t_cursor_origin=a[4]))(
        jnp.asarray(sigma), jnp.asarray(color), jnp.asarray(dt),
        jnp.asarray(mask), jnp.asarray(origin) if with_origin else None)
    got = p_int.integrate(*port(sigma, color, dt, mask), T_NEAR, T_FAR,
                          t_cursor_origin=(torch.from_numpy(origin)
                                           if with_origin else None))
    depth_rtol = 1e-4 if sigma.shape[1] >= 128 else 1e-5
    assert_heads((got.radiance, got.transmittance, got.opacity, got.depth),
                 ref, depth_rtol)
    aux, ref_aux = got.aux.numpy(), np.asarray(ref.aux)
    close(aux[..., :3], ref_aux[..., :3], 1e-5, 1e-6)
    close(aux[..., 3], ref_aux[..., 3], 1e-5, 1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_twin_matches_pallas_interpret(case):
    sigma, color, dt, mask, _, _ = lattice(**CASES[case])
    ref = integrate_pallas(jnp.asarray(sigma), jnp.asarray(color),
                           jnp.asarray(dt), jnp.asarray(mask), T_NEAR, T_FAR,
                           8, True)
    s, planes, d, m = port(sigma, color, dt, mask)
    before = p_fused.integrate_forward.launches
    rows = p_fused.integrate_forward(s, planes, d, m, T_NEAR, T_FAR)
    assert p_fused.integrate_forward.launches == before   # CPU: the twin
    assert rows.shape == (sigma.shape[0], 8)
    depth_rtol = 1e-4 if sigma.shape[1] >= 128 else 1e-5
    close(rows[:, :3], ref[0], 1e-5, 1e-6)
    close(rows[:, 3], ref[1], 1e-5, 1e-7)
    close(rows[:, 4], ref[2], 1e-5, 1e-7)
    close(rows[:, 5], ref[3], depth_rtol, 1e-5)
    assert not rows[:, 6:].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_radiance_gradients_match_jax(case):
    sigma, color, dt, mask, origin, g = lattice(**CASES[case])

    def loss(s, c):
        out = j_int.integrate(s, c, jnp.asarray(dt), jnp.asarray(mask),
                              T_NEAR, T_FAR, with_aux=False)
        return jnp.vdot(out.radiance, jnp.asarray(g))

    ds, dc = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(sigma),
                                                     jnp.asarray(color))
    s, planes, d, m = port(sigma, color, dt, mask)
    s.requires_grad_(True)
    planes = tuple(p.clone().requires_grad_(True) for p in planes)
    rad, _, _, _ = p_fused.integrate_fused(s, planes, d, m, T_NEAR, T_FAR,
                                           torch.from_numpy(origin))
    grads = torch.autograd.grad((rad * torch.from_numpy(g)).sum(),
                                (s,) + planes)
    close(grads[0], ds, 1e-4, 1e-6)
    for i in range(3):
        close(grads[1 + i], np.asarray(dc)[..., i], 1e-4, 1e-7)


def test_radiance_vjp_twin_matches_pallas_backward():
    """K9b's twin against the TPU kernel's backward (interpreted), on a
    lattice without exact-zero sigma, where the two tie values agree."""
    sigma, color, dt, mask, _, g = lattice(seed=5)
    ds, (dr, dg, db) = _bwd_call(jnp.asarray(sigma), jnp.asarray(color),
                                 jnp.asarray(dt), jnp.asarray(mask),
                                 jnp.asarray(g), 8, True)
    got_s, got_c = p_fused.radiance_vjp(*port(sigma, color, dt, mask),
                                        torch.from_numpy(g))
    close(got_s, ds, 1e-4, 1e-6)
    for a, b in zip(got_c, (dr, dg, db)):
        close(a, b, 1e-4, 1e-7)


@pytest.mark.parametrize("case", ["plain", "saturating"])
def test_head_gradients_match_jax(case):
    """The transmittance, opacity and depth heads through the twin's
    autograd, on fields without exact-zero sigma."""
    sigma, color, dt, mask, origin, _ = lattice(**CASES[case], seed=7)
    wt, wo, wd = 1.3, 0.7, 0.2

    def loss(s, c):
        out = j_int.integrate(s, c, jnp.asarray(dt), jnp.asarray(mask),
                              T_NEAR, T_FAR, with_aux=False,
                              t_cursor_origin=jnp.asarray(origin))
        return jnp.sum(wt * out.transmittance + wo * out.opacity
                       + wd * out.depth)

    ds, dc = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(sigma),
                                                     jnp.asarray(color))
    s, planes, d, m = port(sigma, color, dt, mask)
    s.requires_grad_(True)
    planes = tuple(p.clone().requires_grad_(True) for p in planes)
    _, t, op, depth = p_fused.integrate_fused(s, planes, d, m, T_NEAR, T_FAR,
                                              torch.from_numpy(origin))
    grads = torch.autograd.grad((wt * t + wo * op + wd * depth).sum(),
                                (s,) + planes)
    close(grads[0], ds, 1e-4, 1e-6)
    for i in range(3):
        close(grads[1 + i], np.asarray(dc)[..., i], 1e-4, 1e-7)


def test_zero_sigma_tie_convention():
    """At sigma*dt == 0 the port's d_sigma is jnp's (0.5 x the one-sided
    derivative) and half of integrate_pallas's; elsewhere all three
    agree."""
    sigma, color, dt, mask, _, g = lattice(seed=11, zeros=True)
    zero = (sigma == 0.0) & mask
    assert zero.sum() > 100

    def loss(s):
        out = j_int.integrate(s, jnp.asarray(color), jnp.asarray(dt),
                              jnp.asarray(mask), T_NEAR, T_FAR,
                              with_aux=False)
        return jnp.vdot(out.radiance, jnp.asarray(g))

    ds_jnp = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(sigma)))
    ds_pallas = np.asarray(_bwd_call(jnp.asarray(sigma), jnp.asarray(color),
                                     jnp.asarray(dt), jnp.asarray(mask),
                                     jnp.asarray(g), 8, True)[0])
    ds, _ = p_fused.radiance_vjp(*port(sigma, color, dt, mask),
                                 torch.from_numpy(g))
    ds = ds.numpy()
    close(ds, ds_jnp, 1e-4, 1e-6)
    close(ds[~zero], ds_pallas[~zero], 1e-4, 1e-6)
    close(ds[zero], 0.5 * ds_pallas[zero], 1e-4, 1e-6)
    nonzero = np.abs(ds_pallas[zero]) > 1e-4
    assert nonzero.sum() > 10
    assert not np.allclose(ds[zero][nonzero], ds_pallas[zero][nonzero],
                           rtol=0.1)


def test_transmittance_gradient_lands_on_processed_steps():
    """d T / d sigma_j = -T * dt_j on every processed step (the fused
    kernels' convention), also where prefixes tie."""
    sigma, color, dt, mask, _, _ = lattice(seed=13, zeros=True)
    s, planes, d, m = port(sigma, color, dt, mask)
    s.requires_grad_(True)
    _, t, _, _ = p_fused.integrate_fused(s, planes, d, m, T_NEAR, T_FAR)
    (ds,) = torch.autograd.grad(t.sum(), (s,))
    p = torch.exp(-p_int.scan_prefix(torch.clamp_min(s.detach() * d, 0)
                                     * m))
    tb = torch.cat([torch.ones_like(p[:, :1]), p[:, :-1]], dim=1)
    proc = m & (tb > p_int.STOP_THRESHOLD)
    tie = torch.where(s.detach() * d > 0, 1.0, 0.5)
    want = torch.where(proc, -t.detach()[:, None] * d * tie,
                       torch.zeros_like(d))
    close(ds, want, 1e-5, 1e-7)


def test_radiance_only_and_alpha_match_reference():
    sigma, color, dt, mask, _, _ = lattice(seed=2)
    got = p_int.radiance_only(*port(sigma, color, dt, mask))
    ref = j_int.radiance_only(jnp.asarray(sigma), jnp.asarray(color),
                              jnp.asarray(dt), jnp.asarray(mask))
    close(got, ref, 1e-5, 1e-6)
    od = np.concatenate([np.geomspace(1e-7, 200.0, 64, dtype=np.float32),
                         np.array([0.0, -1.0], np.float32)])
    a = p_int.compute_alpha(torch.from_numpy(od), torch.ones(od.size))
    b = j_int.compute_alpha(jnp.asarray(od), jnp.ones(od.size))
    close(a, b, 1e-6, 1e-7)


def test_scan_prefix_is_a_cumulative_sum():
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (5, 77)).astype(np.float32))
    got = p_int.scan_prefix(x)
    close(got, torch.cumsum(x.double(), 1).float(), 1e-6, 1e-5)
    assert torch.equal(p_int.scan_prefix(x[:, :32])[:, :32], got[:, :32])


def test_fused_node_skips_unused_heads():
    """A radiance-only loss never runs the twin's head pullback; a loss
    over T alone leaves the colour gradient zero."""
    sigma, color, dt, mask, _, g = lattice(seed=3)
    s, planes, d, m = port(sigma, color, dt, mask)
    s.requires_grad_(True)
    planes = tuple(p.clone().requires_grad_(True) for p in planes)
    _, t, _, _ = p_fused.integrate_fused(s, planes, d, m, T_NEAR, T_FAR)
    grads = torch.autograd.grad(t.sum(), (s,) + planes)
    assert float(grads[0].abs().max()) > 0
    assert all(float(x.abs().max()) == 0 for x in grads[1:])


# The kernels' launch geometry (csrc/integrate.cu, integrate_bwd.cu) at
# row lengths around the register path's chunks and past it (the grouped
# walk), at 1, 5 and 9,216 rays
@pytest.mark.parametrize("n,k", [(1, 1), (5, 31), (5, 32), (1, 33),
                                 (9216, 96), (5, 128), (1, 129),
                                 (9216, 256)])
def test_launch_geometry_covers_every_step_and_ray(n, k):
    chunks, blocks = p_fused.launch_geometry(n, k)
    width = p_int.SCAN_WIDTH
    span = width * chunks
    groups = -(-k // span)
    assert 1 <= chunks <= p_fused.REGISTER_CHUNKS
    # every step in a chunk, no chunk past the row's last step
    assert (chunks - 1) * width < k <= span * groups
    # the register path holds the whole row; only the most chunks group
    assert (groups == 1) == (k <= width * p_fused.REGISTER_CHUNKS)
    assert groups == 1 or chunks == p_fused.REGISTER_CHUNKS
    # one warp a ray, no block without a ray
    assert (blocks - 1) * p_fused.WARPS_PER_BLOCK < n
    assert blocks * p_fused.WARPS_PER_BLOCK >= n
