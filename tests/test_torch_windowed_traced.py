"""``render_windowed_traced`` against dvren_tpu's, on the CPU.

JAX's form takes a prebuilt schedule and stages the frame as one traced
program; the port's shares ``render_windowed``'s body and runs eagerly.
Same seeded inputs (tests/test_torch_windowed.py's scenes, 64-ray groups,
groups recomputed in the backward or kept). Held: the planes within 5e-6
(the hitmask equal), the grid gradients of mean(image^2) within 5e-6 x
their largest magnitude, the camera gradients through ``k`` / ``c2w``
within rtol 2e-3 / atol 1e-4 (tests/test_fused_tiles.py:171's bound); the
schedule is required and must sit on the field's device; it is exported
at the top level as JAX's is.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu.render import windowed as j_win
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_windowed import (CAM_ATOL, CAM_RTOL, TOL, jitter_of,
                                       scene)

from dvren_tpu_torch.ops.raygen import camera_arrays
from dvren_tpu_torch.render import windowed as p_win

torch.set_num_threads(1)

CASES = [("stratified", False), ("stratified", True), ("fixed", None),
         ("ortho", None)]


@functools.lru_cache(maxsize=None)
def traced(name, remat):
    """(JAX's planes and gradients, the port's) of mean(image^2)."""
    plan, field = scene(name)
    jitter = jitter_of(plan)
    camera = name != "ortho"
    jsched = j_win.build_schedule(plan, field.bbox_min, field.bbox_max,
                                  jitter=jitter, block=64)
    k0 = jnp.asarray(plan.camera.k, jnp.float32).reshape(3, 3)
    c2w0 = jnp.asarray(plan.camera.c2w, jnp.float32).reshape(3, 4)

    def frame(params, c2w, k, s):
        f = field.with_params(*params)
        return j_win.render_windowed_traced(
            plan, f, s, remat=remat, k=k if camera else None,
            c2w=c2w if camera else None)

    def loss(params, c2w, k, s):
        return jnp.mean(frame(params, c2w, k, s).image ** 2)

    args = ((field.sigma, field.color), c2w0, k0, jsched)
    jplanes = jax.jit(frame)(*args)
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)

    pp = port_plan(plan)
    psched = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                  jitter=jitter, block=64, device="cpu")
    pf = port_field(field)
    k, c2w, _ = camera_arrays(pp, "cpu")
    k.requires_grad_(camera)
    c2w.requires_grad_(camera)
    planes = P.render_windowed_traced(
        pp, pf, psched, remat=remat, k=k if camera else None,
        c2w=c2w if camera else None)
    wrt = (pf.sigma, pf.color) + ((c2w, k) if camera else ())
    pgrads = torch.autograd.grad(torch.mean(planes.image ** 2), wrt)
    jflat = (jgrads[0][0], jgrads[0][1]) + (
        (jgrads[1], jgrads[2]) if camera else ())
    return jplanes, jflat, planes, pgrads


@pytest.mark.parametrize("name, remat", CASES)
def test_planes_match_jax(name, remat):
    ref, _, got, _ = traced(name, remat)
    for key in ("image", "transmittance", "opacity", "depth"):
        np.testing.assert_allclose(getattr(got, key).detach().numpy(),
                                   np.asarray(getattr(ref, key)), atol=TOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(got.hitmask.numpy(),
                                  np.asarray(ref.hitmask))


@pytest.mark.parametrize("name, remat", CASES)
def test_gradients_match_jax(name, remat):
    _, ref, _, got = traced(name, remat)
    for want, have in zip(ref[:2], got[:2]):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0.0
        np.testing.assert_allclose(have.numpy(), want, rtol=0,
                                   atol=TOL * scale)
    for want, have in zip(ref[2:], got[2:]):
        np.testing.assert_allclose(have.numpy(), np.asarray(want),
                                   rtol=CAM_RTOL, atol=CAM_ATOL)


def test_equals_render_windowed():
    plan, field = scene("stratified")
    pp, pf = port_plan(plan), port_field(field)
    sched = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                 jitter=jitter_of(plan), device="cpu")
    with torch.no_grad():
        a = P.render_windowed_traced(pp, pf, sched)
        b = P.render_windowed(pp, pf, sched)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key


def test_schedule_is_required_on_the_field_device():
    plan, field = scene("fixed")
    pp, pf = port_plan(plan), port_field(field)
    host = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                device=False)
    with pytest.raises(P.DvrenError, match="move it"):
        P.render_windowed_traced(pp, pf, host)
    with pytest.raises(TypeError):
        P.render_windowed_traced(pp, pf)


def test_jitter_beside_a_rowless_schedule_is_refused():
    """A prebuilt schedule without jitter rows hashes the plan's jitter:
    a ``jitter=`` table beside it would be ignored, so it is refused."""
    plan, field = scene("stratified")
    pp, pf = port_plan(plan), port_field(field)
    jitter = jitter_of(plan)
    rowless = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                   device="cpu")
    with pytest.raises(P.DvrenError, match="no jitter rows"):
        P.render_windowed(pp, pf, rowless, jitter=jitter)
    rows = p_win.build_schedule(pp, field.bbox_min, field.bbox_max,
                                jitter=jitter, device="cpu")
    with torch.no_grad():
        a = P.render_windowed(pp, pf, rows, jitter=jitter)
        b = P.render_windowed(pp, pf, rowless)
    assert torch.equal(a.image, b.image)
