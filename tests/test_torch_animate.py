"""``all_tiles`` and the moving-camera renderer (``render/animate.py``),
against dvren_tpu.

Mirrors ``tests/test_animate.py``: every pose's planes through
``MovingCameraRenderer`` equal ``render_tiled`` on that pose's own
schedule bit for bit, including a pose that leaves the bbox (dead tiles
render the background); a field update keeps the one structure; a
geometry change, a pose over the pinned shape and overflow rays are
refused; ``canonical_stats`` removes what the camera changes. The
``all_tiles`` schedule equals JAX's array for array, and a pose's frame
JAX's reference consumer within 5e-6.
"""

import functools

import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.render import animate
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

G, W, STEPS = 8, 64, 32


@functools.lru_cache(maxsize=None)
def jax_field():
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, G)] * 3), indexing="ij")
    sigma = (12 * np.exp(-((xs - .5) ** 2 + (ys - .5) ** 2
                           + (zs - .45) ** 2) / .05)).astype(np.float32)
    color = np.stack([xs, ys, 1 - zs], -1).astype(np.float32)
    return J.DenseGridField.create(J.DenseGridConfig(
        resolution=(G,) * 3, sigma=sigma.reshape(-1),
        color=color.reshape(-1)))


def jax_plan(tx, ty, steps=STEPS):
    return J.Plan.create(J.PlanConfig(
        width=W, height=W, t_near=0.2, t_far=2.2, seed=3,
        camera=J.CameraConfig(
            k=(W * 1.2, 0, W / 2, 0, W * 1.2, W / 2, 0, 0, 1),
            c2w=(1, 0, 0, tx, 0, 1, 0, ty, 0, 0, 1, -1.0)),
        sampling=J.SamplingConfig(dt=2.0 / steps, max_steps=steps,
                                  mode=J.SamplingMode.STRATIFIED)))


def plan(tx, ty, steps=STEPS):
    return port_plan(jax_plan(tx, ty, steps))


def field():
    return port_field(jax_field())


def test_moving_camera_bit_exact_one_structure():
    f = field()
    r = animate.MovingCameraRenderer(plan(0.5, 0.5), f)
    # the third pose pushes part of the frame off the bbox: the all_tiles
    # group still carries those tiles, masked, bit for bit
    for tx, ty in [(0.5, 0.5), (0.55, 0.48), (1.05, 0.6)]:
        p = plan(tx, ty)
        with torch.no_grad():
            got = r.render(p, f)
            ref = p_tiled.render_tiled(
                p, f, p_tiled.build_tiled_schedule(p, f).to("cpu"))
        for key in ("image", "depth", "transmittance", "opacity"):
            assert torch.equal(getattr(got, key), getattr(ref, key)), key
    assert r.cache_size() == 1


def test_moving_camera_field_update_shares_structure():
    f = field()
    r = animate.MovingCameraRenderer(plan(0.5, 0.5), f)
    f2 = f.with_params(f.sigma.detach() * 1.3, f.color.detach())
    with torch.no_grad():
        a = r.render(plan(0.5, 0.5), f)
        b = r.render(plan(0.52, 0.47), f2)
    assert float((a.image - b.image).abs().max()) > 0
    assert r.cache_size() == 1


def test_moving_camera_refusals():
    f = field()
    r = animate.MovingCameraRenderer(plan(0.5, 0.5), f)
    with pytest.raises(P.DvrenError, match="beyond the camera"):
        r.render(plan(0.5, 0.5, steps=16), f)
    tight = animate.MovingCameraRenderer(plan(0.5, 0.5), f,
                                         uniform_shape=(1, 1))
    with pytest.raises(P.DvrenError, match="uniform_shape"):
        tight.render(plan(0.5, 0.5), f)
    # a fine grid overflows the 16 px slot tables: refused, not rendered
    n = 96
    fine = P.DenseGridField.from_reference_arrays(
        np.ones((n, n, n), np.float32), np.ones((n, n, n, 3), np.float32),
        (0, 0, 0), (1, 1, 1), device="cpu")
    with pytest.raises(P.DvrenError, match="overflow"):
        animate.MovingCameraRenderer(plan(0.5, 0.5), fine)
    with pytest.raises(P.DvrenError, match="overflow"):
        r.render(plan(0.5, 0.5), fine)


def test_canonical_stats_strips_variation():
    f = field()
    structures = []
    for tx in (0.5, 0.62):
        p = plan(tx, 0.5)
        s = p_tiled.build_tiled_schedule(p, f, quantize="uniform",
                                         uniform_shape=(4, 3), all_tiles=True)
        c = animate.canonical_stats(s)
        assert c.gather_plan is None and c.tiled_samples == 0
        assert all(g.samples == 0 for g in c.groups)
        structures.append(animate.schedule_structure(c))
    assert structures[0] == structures[1]


@pytest.mark.parametrize("tx", [0.5, 1.05])
def test_all_tiles_schedule_and_frame_match_jax(tx):
    jp, jf = jax_plan(tx, 0.5), jax_field()
    kw = dict(quantize="uniform", uniform_shape=(4, 3), all_tiles=True)
    ref = j_tiled.build_tiled_schedule(jp, jf, device=False,
                                       jitter=plan_jitter_table(jp), **kw)
    got = p_tiled.build_tiled_schedule(port_plan(jp), field(), **kw)
    assert len(got.groups) == 1
    assert got.groups[0].n_tiles == 16        # every 16 px tile of 64^2
    assert_schedules_equal(ref, got)
    want = j_tiled.render_tiled(jp, jf, ref, use_kernel=False)
    with torch.no_grad():
        out = p_tiled.render_tiled(port_plan(jp), field(), got.to("cpu"))
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   np.asarray(getattr(want, key)), atol=5e-6,
                                   rtol=0, err_msg=key)
