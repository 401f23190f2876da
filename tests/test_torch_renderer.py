"""The slice end to end: dvren_tpu_torch's Renderer.forward against
dvren_tpu's tiled Renderer.forward.

The JAX Renderer picks tiles by default only on a TPU, so its side pins
``RenderOptions(use_tiles=True)``; the general paths (``use_tiles=False``,
the CPU default, streaming, override bundles) are held to the JAX
Renderer with the same options. Planes within 5e-6, depth within 1e-4,
hitmask equal (tests/test_tiled.py::assert_planes_close). On the card,
tests/test_torch_cuda.py holds the CUDA path to this CPU path.
"""

import functools

import jax.numpy as jnp
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
        "streaming": P.RenderOptions(streaming=True),
        "enable_graph": P.RenderOptions(use_tiles=True, enable_graph=True),
        "occupancy": P.RenderOptions(use_tiles=True, use_occupancy=True),
        "pitch2": P.RenderOptions(use_tiles=True, tile_pitch=2),
    }[case]


@functools.lru_cache(maxsize=None)
def reference_general(case):
    """The JAX Renderer's frame on the general paths (``case`` names the
    options of :func:`_options_case`)."""
    plan, field = scene(**SCENES["fixed"])
    options = {"use_tiles_false": dict(use_tiles=False), "auto_on_cpu": {},
               "streaming": dict(streaming=True)}[case]
    return J.Renderer(J.Context.create(), plan,
                      J.RenderOptions(capture_stats=False, **options)
                      ).forward(field)


@pytest.mark.parametrize("case", ["use_tiles_false", "auto_on_cpu",
                                  "streaming", "enable_graph",
                                  "occupancy", "pitch2"])
def test_unported_modes_raise(case):
    """Every mode is ported: ``use_tiles=False``, the default on a CPU
    context (the fused path) and ``streaming`` render the JAX Renderer's
    frame with the same options; ``use_occupancy`` and ``tile_pitch=2``
    the tiled reference's, occupancy within 5e-6 and pitch 2 bit for bit
    with the port's pitch 1; ``enable_graph`` on a CPU context has no
    CUDA graph to record, so it renders the tiled path eagerly (the
    tiled reference's frame, bit for bit the port's frame without it)
    and says so in the note ``graph_capture=none:cpu``."""
    plan, field, ref = reference("fixed")
    renderer = port_renderer(plan, _options_case(case))
    if case in ("occupancy", "pitch2"):
        got = renderer.forward(port_field(field))
        assert_planes_close(_Planes(got, plan), _Planes(ref, plan), tol=5e-6)
        if case == "pitch2":
            base = port_renderer(plan).forward(port_field(field))
            np.testing.assert_array_equal(got.image, base.image)
            np.testing.assert_array_equal(got.depth, base.depth)
        return
    if case == "enable_graph":
        got = renderer.forward(port_field(field))
        assert "graph_capture=none:cpu" in got.stats.notes
        assert "graph_executed" not in got.stats.notes
        assert_planes_close(_Planes(got, plan), _Planes(ref, plan), tol=5e-6)
        eager = port_renderer(plan).forward(port_field(field))
        np.testing.assert_array_equal(got.image, eager.image)
        np.testing.assert_array_equal(got.depth, eager.depth)
        return
    got = renderer.forward(port_field(field))
    want = reference_general(case)
    assert_planes_close(_Planes(got, plan), _Planes(want, plan), tol=5e-6)
    assert got.sample_count == want.sample_count
    assert renderer._last_mode == ("streamed" if case == "streaming"
                                   else "fused")


def test_override_rays_raise():
    """Override bundles are ported: a bundle of the plan's own rays,
    reversed, renders the JAX Renderer's override frame (its rays own
    their pixels, so it is also the generated frame)."""
    from dvren_tpu.ops.raygen import Rays as JRays
    from dvren_tpu.ops.raygen import generate_rays as j_generate_rays
    from dvren_tpu_torch.ops.raygen import Rays as PRays

    plan, field, tiled_ref = reference("fixed")
    jr = j_generate_rays(plan)
    back = {k: np.asarray(getattr(jr, k))[::-1].copy()
            for k in ("origins", "directions", "t_near", "t_far",
                      "pixel_ids")}
    ref = J.Renderer(J.Context.create(), plan).forward(
        field, rays=JRays(**{k: jnp.asarray(v) for k, v in back.items()}))
    got = port_renderer(plan).forward(
        port_field(field),
        rays=PRays(**{k: torch.from_numpy(v) for k, v in back.items()}))
    assert_planes_close(_Planes(got, plan), _Planes(ref, plan), tol=5e-6)
    assert_planes_close(_Planes(got, plan), _Planes(tiled_ref, plan),
                        tol=5e-6)
    assert got.ray_count == plan.ray_count


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
    """Rays that still overflow the schedule the cascade keeps ride the
    windowed fallback: the cascade rebuilds its choice with it, as JAX's
    does, and render_tiled and the Renderer render them; a cascade probe
    (``build_fallback=False``) with overflow rays is refused. The scene: a
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
    assert_schedules_equal(ref, sched)
    probe = p_tiled.build_tiled_schedule(plan, field, tile_px=8,
                                         cell_scale=2, build_fallback=False)
    with torch.no_grad(), pytest.raises(P.DvrenError,
                                        match="build_fallback=False"):
        p_tiled.render_tiled(plan, field, probe.to("cpu"))
    got, got_note = p_tiled.build_tiled_schedule_auto(plan, field)
    assert got_note == note and got.fallback is not None
    assert_schedules_equal(ref, got)
    want = j_tiled.render_tiled(jplan, jfield, ref, use_kernel=False)
    with torch.no_grad():
        assert_planes_close(p_tiled.render_tiled(plan, field, sched.to("cpu")),
                            want, tol=5e-6)
    res = P.Renderer(P.Context.create(device="cpu"), plan,
                     P.RenderOptions(use_tiles=True)).forward(field)
    assert "tiled_path" in res.stats.notes
    assert_planes_close(_Planes(res, plan), want, tol=5e-6)


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
    """Every option is ported. Pitch 2, occupancy and ``bank_aligned``
    build the schedule JAX builds (ROADMAP items 5 and 15, and the
    closing slice), and ``all_tiles`` refuses a schedule without uniform
    quantization, as JAX's does."""
    plan, field, _ = reference("fixed")
    if "all_tiles" in kwargs:
        with pytest.raises(P.DvrenError, match="uniform quantization"):
            p_tiled.build_tiled_schedule(port_plan(plan), port_field(field),
                                         **kwargs)
        return
    ref = j_tiled.build_tiled_schedule(plan, field, device=False, **kwargs)
    got = p_tiled.build_tiled_schedule(port_plan(plan), port_field(field),
                                       **kwargs)
    assert_schedules_equal(ref, got)


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
    # fallback parts overwrite their rays' pixels; ids past the frame drop
    part = (torch.tensor([3, 16 * 32 + 5], dtype=torch.int32),
            torch.full((2, 3), 0.25), torch.full((2,), 0.5),
            torch.full((2,), 0.5), torch.full((2,), 1.5))
    planes = p_tiled._compose_tiles(plan, [raw], [ids], fallback_parts=[part])
    assert torch.all(planes.image[0, 3] == 0.25)
    assert float(planes.transmittance[0, 3]) == 0.5
    assert float(planes.depth[0, 3]) == 1.5
    assert float(planes.image.sum()) == 16 * 16 * 3 + 0.75


def test_plain_path_equals_wrappers_on_cpu():
    plan, field, _ = reference("roi")
    pplan, pfield = port_plan(plan), port_field(field)
    sched = p_tiled.build_tiled_schedule(pplan, pfield).to("cpu")
    with torch.no_grad():
        a = p_tiled.render_tiled(pplan, pfield, sched)
        b = p_tiled.render_tiled(pplan, pfield, sched, use_kernel=False)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
