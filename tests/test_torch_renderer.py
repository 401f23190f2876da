"""The slice end to end: dvren_tpu_torch's Renderer.forward against
dvren_tpu's tiled Renderer.forward.

The JAX Renderer picks tiles by default only on a TPU, so its side pins
``RenderOptions(use_tiles=True)``. Planes within 5e-6, depth within 1e-4,
hitmask equal (tests/test_tiled.py::assert_planes_close). On the card,
tests/test_torch_cuda.py holds the CUDA path to this CPU path.
"""

import functools

import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.render import tiled as j_tiled
from tests.test_tiled import assert_planes_close, scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.ops.compose import ImagePlanes
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

SCENES = {
    "fixed": {},
    "stratified": dict(mode=J.SamplingMode.STRATIFIED),
    "roi": dict(width=50, height=38, roi=J.Roi(x=3, y=5, width=41,
                                                 height=27)),
}


class _Planes:
    """A ForwardResult's flat arrays in (H, W) plane shape."""

    def __init__(self, res, plan):
        h, w = plan.height, plan.width
        self.image = res.image.reshape(h, w, 3)
        self.transmittance = res.transmittance.reshape(h, w)
        self.opacity = res.opacity.reshape(h, w)
        self.depth = res.depth.reshape(h, w)
        self.hitmask = res.hitmask.reshape(h, w)


@functools.lru_cache(maxsize=None)
def reference(name):
    plan, field = scene(**SCENES[name])
    res = J.Renderer(J.Context.create(), plan,
                     J.RenderOptions(use_tiles=True, capture_stats=False)
                     ).forward(field)
    return plan, field, res


def port_renderer(plan, options=None):
    return P.Renderer(P.Context.create(device="cpu"), port_plan(plan),
                      options or P.RenderOptions(use_tiles=True))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_forward_matches_reference(name):
    plan, field, ref = reference(name)
    got = port_renderer(plan).forward(port_field(field))
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert getattr(got, key).dtype == getattr(ref, key).dtype, key
        assert getattr(got, key).shape == getattr(ref, key).shape, key
    assert_planes_close(_Planes(got, plan), _Planes(ref, plan), tol=5e-6)
    assert (got.ray_count, got.sample_count) == (ref.ray_count,
                                                 ref.sample_count)
    assert "tiled_path" in got.stats.notes


def test_schedule_built_once_and_replayed():
    plan, field, _ = reference("stratified")
    renderer = port_renderer(plan)
    pfield = port_field(field)
    first = renderer.forward(pfield)
    assert any(n.startswith("tiled_schedule_build_ms=")
               for n in first.stats.notes)
    again = renderer.forward(pfield)
    assert not any(n.startswith("tiled_schedule_build_ms=")
                   for n in again.stats.notes)
    np.testing.assert_array_equal(again.image, first.image)
    # new values, same bbox and resolution: the schedule is reused
    brighter = P.DenseGridField.from_reference_arrays(
        np.asarray(field.sigma) * 2.0, np.asarray(field.color),
        field.bbox_min, field.bbox_max, device="cpu")
    third = renderer.forward(brighter)
    assert not any(n.startswith("tiled_schedule_build_ms=")
                   for n in third.stats.notes)
    assert third.opacity.sum() > first.opacity.sum()


def test_cpu_forward_launches_no_kernel():
    plan, field, _ = reference("fixed")
    res = port_renderer(plan).forward(port_field(field))
    assert "kernel_launches=fused_tiles:0,packed_table:0" in res.stats.notes


def _options_case(case):
    return {
        "use_tiles_false": P.RenderOptions(use_tiles=False),
        "auto_on_cpu": P.RenderOptions(),
        "use_window": P.RenderOptions(use_window=True),
        "enable_graph": P.RenderOptions(use_tiles=True, enable_graph=True),
        "occupancy": P.RenderOptions(use_tiles=True, use_occupancy=True),
        "pitch2": P.RenderOptions(use_tiles=True, tile_pitch=2),
    }[case]


@pytest.mark.parametrize("case", ["use_tiles_false", "auto_on_cpu",
                                  "use_window", "enable_graph",
                                  "occupancy", "pitch2"])
def test_unported_modes_raise(case):
    plan, field, _ = reference("fixed")
    renderer = port_renderer(plan, _options_case(case))
    with pytest.raises(NotImplementedError):
        renderer.forward(port_field(field))


def test_override_rays_raise():
    plan, field, _ = reference("fixed")
    with pytest.raises(NotImplementedError):
        port_renderer(plan).forward(port_field(field), rays=object())


def test_ineligible_fields_rejected():
    plan, field, _ = reference("fixed")
    clamp = P.DenseGridField.from_reference_arrays(
        np.asarray(field.sigma), np.asarray(field.color), field.bbox_min,
        field.bbox_max, oob=P.OobPolicy.CLAMP, device="cpu")
    with pytest.raises(P.DvrenError):
        port_renderer(plan).forward(clamp)


def _ones_scene(n, width, height, focal, c2w, t_near=0.1):
    """A JAX plan and a dense n^3 field of ones over the unit cube (a
    schedule depends only on the geometry)."""
    plan = J.Plan.create(J.PlanConfig(
        width=width, height=height, t_near=t_near, t_far=3.1,
        camera=J.CameraConfig(k=(focal, 0, width / 2, 0, focal, height / 2,
                                 0, 0, 1), c2w=c2w),
        sampling=J.SamplingConfig(dt=0.05, max_steps=60)))
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n), sigma=np.ones(n ** 3),
        color=np.ones(3 * n ** 3)))
    return plan, field


def test_overflowing_schedule_raises():
    """Rays that still overflow the schedule the cascade keeps need the
    windowed fallback (ROADMAP item 11), which is not ported: the auto
    build, render_tiled and the Renderer raise naming it. The scene: a
    48x32 camera (focal 24 px) 1.1 in front of a 32^3 grid, on which
    JAX's cascade also keeps 8 px supercells with overflow rays left."""
    jplan, jfield = _ones_scene(32, 48, 32, 24.0,
                                (1, 0, 0, 0.2, 0, 1, 0, 0.5, 0, 0, 1, -1.1),
                                t_near=0.05)
    ref, note = j_tiled.build_tiled_schedule_auto(jplan, jfield, device=False)
    assert note == "tiled_supercell_8px" and ref.fallback_rays > 0
    plan, field = port_plan(jplan), port_field(jfield)
    sched = p_tiled.build_tiled_schedule(plan, field, tile_px=8, cell_scale=2)
    assert sched.fallback_rays == ref.fallback_rays
    with pytest.raises(NotImplementedError, match="item 11"):
        p_tiled.build_tiled_schedule_auto(plan, field)
    with torch.no_grad(), pytest.raises(NotImplementedError, match="item 11"):
        p_tiled.render_tiled(plan, field, sched.to("cpu"))
    with pytest.raises(NotImplementedError, match="item 11"):
        P.Renderer(P.Context.create(device="cpu"), plan,
                   P.RenderOptions(use_tiles=True)).forward(field)


def test_cascade_rescues_overflowing_scene():
    """A 32x32 camera over a 64^3 grid overflows every 16 px cell tile;
    the cascade picks the configuration JAX's picks, with its arrays, and
    the Renderer renders the frame JAX's reference consumer renders."""
    jplan, jfield = _ones_scene(64, 32, 32, 32.0,
                                (1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.1))
    ref, note = j_tiled.build_tiled_schedule_auto(jplan, jfield, device=False)
    plan, field = port_plan(jplan), port_field(jfield)
    assert p_tiled.build_tiled_schedule(plan, field).fallback_rays > 0
    got, got_note = p_tiled.build_tiled_schedule_auto(plan, field)
    assert got.fallback_rays == ref.fallback_rays == 0
    assert (got.tile_px, got.cell_scale, got_note) == (ref.tile_px,
                                                       ref.cell_scale, note)
    assert note is not None
    assert_schedules_equal(ref, got)
    res = P.Renderer(P.Context.create(device="cpu"), plan,
                     P.RenderOptions(use_tiles=True)).forward(field)
    assert note in res.stats.notes
    want = j_tiled.render_tiled(jplan, jfield, ref, use_kernel=False)
    assert_planes_close(_Planes(res, plan), want, tol=5e-6)


@pytest.mark.parametrize("kwargs", [dict(pitch=2), dict(occupancy=True),
                                    dict(all_tiles=True),
                                    dict(bank_aligned=True)])
def test_unported_schedule_options_raise(kwargs):
    plan, field, _ = reference("fixed")
    with pytest.raises(NotImplementedError):
        p_tiled.build_tiled_schedule(port_plan(plan), port_field(field),
                                     **kwargs)


@pytest.mark.parametrize("kwargs", [dict(tile_px=8), dict(cell_scale=2)])
def test_schedule_options_build_reference(kwargs):
    """``tile_px`` and ``cell_scale`` build the JAX package's schedule."""
    plan, field, _ = reference("fixed")
    ref = j_tiled.build_tiled_schedule(plan, field, device=False, **kwargs)
    got = p_tiled.build_tiled_schedule(port_plan(plan), port_field(field),
                                       **kwargs)
    assert_schedules_equal(ref, got)


def test_render_tiled_refuses_wrong_device():
    plan, field, _ = reference("fixed")
    pplan, pfield = port_plan(plan), port_field(field)
    sched = p_tiled.build_tiled_schedule(pplan, pfield)
    with torch.no_grad(), pytest.raises(P.DvrenError):
        p_tiled.render_tiled(pplan, pfield, sched)      # still numpy
    with pytest.raises(P.DvrenError):
        p_tiled.render_tiled(pplan, pfield, sched)


def test_render_tiled_records_gradients():
    """render_tiled is differentiable: autograd records the field's
    parameters through one node, and grad mode changes no value."""
    plan, field, _ = reference("fixed")
    pplan, pfield = port_plan(plan), port_field(field)
    sched = p_tiled.build_tiled_schedule(pplan, pfield).to("cpu")
    planes = p_tiled.render_tiled(pplan, pfield, sched)
    assert planes.image.requires_grad and planes.opacity.requires_grad
    d_sigma, d_color = torch.autograd.grad(planes.image.sum(),
                                           (pfield.sigma, pfield.color))
    assert d_sigma.shape == pfield.sigma.shape
    assert d_color.shape == pfield.color.shape
    assert float(d_color.abs().sum()) > 0.0
    with torch.no_grad():
        again = p_tiled.render_tiled(pplan, pfield, sched)
    assert torch.equal(again.image, planes.image.detach())


def test_compose_drops_sentinel_tiles():
    """Pad tiles carry id 1 << 30 and are dropped (JAX ``mode="drop"``);
    tiles nobody renders keep the background."""
    plan = P.Plan.create(P.PlanConfig(width=32, height=16, t_near=0.0,
                                      t_far=2.0))
    raw = torch.ones((2, 5, 16, 16))
    ids = torch.tensor([[1], [1 << 30]], dtype=torch.int32)
    planes = p_tiled._compose_tiles(plan, [raw], [ids])
    assert isinstance(planes, ImagePlanes)
    assert planes.image.shape == (16, 32, 3)
    assert torch.all(planes.image[:, 16:] == 1.0)
    assert torch.all(planes.image[:, :16] == 0.0)
    assert torch.all(planes.transmittance[:, :16] == 1.0)
    assert torch.all(planes.depth[:, :16] == 2.0)
    assert torch.all(planes.hitmask == 1)
    with pytest.raises(NotImplementedError):
        p_tiled._compose_tiles(plan, [raw], [ids], fallback_parts=[()])


def test_plain_path_equals_wrappers_on_cpu():
    plan, field, _ = reference("roi")
    pplan, pfield = port_plan(plan), port_field(field)
    sched = p_tiled.build_tiled_schedule(pplan, pfield).to("cpu")
    with torch.no_grad():
        a = p_tiled.render_tiled(pplan, pfield, sched)
        b = p_tiled.render_tiled(pplan, pfield, sched, use_kernel=False)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
