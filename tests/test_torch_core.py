"""dvren_tpu_torch core, host geometry and field against dvren_tpu.

Plans, jitter tables and host ray geometry must be EQUAL to the JAX
package's (integer and host products); both packages get the same inputs.
Also holds the port to its two rules: it imports no JAX, and asking for
CUDA where there is none raises instead of running on the CPU.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.ops import rng as j_rng
from dvren_tpu.render import pipeline as j_pipeline
from dvren_tpu.render import windowed as j_windowed
from tests.test_tiled import scene

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import rng as p_rng
from dvren_tpu_torch.render import pipeline as p_pipeline
from dvren_tpu_torch.render import windowed as p_windowed

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


# ----------------------------------------------------------- shared helpers


def port_config(cfg: "J.PlanConfig") -> "P.PlanConfig":
    """The port's PlanConfig with the same values as a JAX PlanConfig."""
    cam = cfg.camera
    return P.PlanConfig(
        width=cfg.width, height=cfg.height, t_near=cfg.t_near,
        t_far=cfg.t_far, max_rays=cfg.max_rays,
        max_samples=cfg.max_samples, seed=cfg.seed,
        camera=P.CameraConfig(model=P.CameraModel(int(cam.model)),
                              k=tuple(cam.k), c2w=tuple(cam.c2w),
                              ortho_scale=cam.ortho_scale),
        roi=P.Roi(cfg.roi.x, cfg.roi.y, cfg.roi.width, cfg.roi.height),
        sampling=P.SamplingConfig(
            dt=cfg.sampling.dt, max_steps=cfg.sampling.max_steps,
            mode=P.SamplingMode(int(cfg.sampling.mode))))


def port_plan(plan: "J.Plan") -> "P.Plan":
    return P.Plan.create(port_config(plan.descriptor()))


def port_field(field, device="cpu") -> "P.DenseGridField":
    """The JAX field's state carried across as numpy."""
    return P.DenseGridField.from_reference_arrays(
        np.asarray(field.sigma), np.asarray(field.color), field.bbox_min,
        field.bbox_max, oob=P.OobPolicy(int(field.oob)),
        interp=P.InterpMode(int(field.interp)), device=device)


def plan_fields(plan) -> dict:
    """A plan as plain values (enums as ints) for comparison."""
    cam, roi, smp = plan.camera, plan.roi, plan.sampling
    return dict(
        width=plan.width, height=plan.height, t_near=plan.t_near,
        t_far=plan.t_far, max_rays=plan.max_rays,
        max_samples=plan.max_samples, seed=plan.seed,
        camera=(int(cam.model), cam.k, cam.c2w, cam.ortho_scale),
        roi=(roi.x, roi.y, roi.width, roi.height),
        sampling=(smp.dt, smp.max_steps, int(smp.mode)),
        ray_count=plan.ray_count,
        lattice=plan.sample_lattice_shape)


# ----------------------------------------------------------------- the rules


def test_import_leaves_jax_out():
    code = ("import sys, dvren_tpu_torch, dvren_tpu_torch.render.tiled, "
            "dvren_tpu_torch.ops.fused_tiles, dvren_tpu_torch._build; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'dvren_tpu' "
            "or m.startswith('dvren_tpu.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sources_never_import_jax_or_the_reference():
    for path in (REPO / "dvren_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "dvren_tpu"), \
                    f"{path}: {line}"


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """chip_smoke.py runs where JAX is absent: it imports neither JAX nor
    dvren_tpu nor the tests package, and of the tests' files it loads
    only the numpy oracle, by its path."""
    text = (REPO / "chip_smoke.py").read_text()
    for line in text.splitlines():
        words = line.strip().split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            root = words[1].split(".")[0]
            assert root not in ("jax", "jaxlib", "dvren_tpu", "tests"), line
    loaded = set(re.findall(r'"tests",\s*"(\w+\.py)"', text))
    assert loaded == {"oracle.py"}, loaded


def test_cuda_context_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(P.DvrenError):
        P.Context.create(device="cuda")
    with pytest.raises(P.DvrenError):
        P.Context.create(P.ContextOptions(preferred_device="cuda:0"))
    # no device named means CUDA, never a silent CPU
    with pytest.raises(P.DvrenError):
        P.Context.create()
    with pytest.raises(P.DvrenError):
        P.Context.create(P.ContextOptions())


def test_context_devices():
    ctx = P.Context.create(device="cpu")
    assert ctx.device == torch.device("cpu") and ctx.platform == "cpu"
    assert ctx.version == (0, 1, 0)
    with pytest.raises(P.DvrenError):
        P.Context.create(device="not-a-device")
    assert P.Context.create(P.ContextOptions(
        preferred_device="cpu")).device == torch.device("cpu")
    if torch.cuda.is_available():
        assert P.Context.create().device == torch.device("cuda", 0)
    else:
        with pytest.raises(P.DvrenError, match="no CUDA"):
            P.Context.create()


# --------------------------------------------------------------------- plans


def _cfg(**kw):
    base = dict(width=64, height=48, t_near=0.0, t_far=1.0)
    base.update(kw)
    return J.PlanConfig(**base)


PLAN_CASES = {
    "defaults": _cfg(),
    "zero_focal": _cfg(camera=J.CameraConfig(
        k=(0.0, 0, 100.0, 0, 0.0, 50.0, 0, 0, 1.0))),
    "ortho": _cfg(camera=J.CameraConfig(
        model=J.CameraModel.ORTHOGRAPHIC, ortho_scale=0.0)),
    "roi": _cfg(roi=J.Roi(x=2, y=2, width=8, height=4)),
    "sampling": _cfg(t_near=1.0, t_far=3.0),
    "max_samples": _cfg(sampling=J.SamplingConfig(dt=0.1, max_steps=16)),
    "stratified": _cfg(seed=9, sampling=J.SamplingConfig(
        dt=0.02, max_steps=40, mode=J.SamplingMode.STRATIFIED)),
}

BAD_PLANS = {
    "zero_width": _cfg(width=0),
    "zero_height": _cfg(height=0),
    "equal_range": _cfg(t_near=1.0, t_far=1.0),
    "reversed_range": _cfg(t_near=2.0, t_far=1.0),
    "roi_outside": _cfg(roi=J.Roi(x=60, y=0, width=8, height=8)),
    "roi_over_max_rays": _cfg(max_rays=10),
    "max_samples_below_rays": _cfg(max_samples=5),
    "short_k": _cfg(camera=J.CameraConfig(k=(1.0,) * 8)),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_defaults_match_reference(name):
    cfg = PLAN_CASES[name]
    ref = J.Plan.create(cfg)
    got = P.Plan.create(port_config(cfg))
    assert plan_fields(got) == plan_fields(ref)
    assert P.Plan.create(got.descriptor()) == got
    assert hash(got) == hash(P.Plan.create(port_config(cfg)))


@pytest.mark.parametrize("name", sorted(BAD_PLANS))
def test_plan_validation_matches_reference(name):
    cfg = BAD_PLANS[name]
    with pytest.raises(J.DvrenError) as ref:
        J.Plan.create(cfg)
    with pytest.raises(P.DvrenError) as got:
        P.Plan.create(port_config(cfg))
    assert str(got.value) == str(ref.value)


# ------------------------------------------------------------------- jitter


@pytest.mark.parametrize("seed,n_rays,n_steps,offset", [
    (0, 7, 5, 0), (17, 64, 60, 0), (2 ** 40 + 3, 33, 9, 1000),
    (2 ** 64 - 1, 4, 130, 2 ** 31)])
def test_jitter_table_bit_equal(seed, n_rays, n_steps, offset):
    ref = j_rng.jitter_table(seed, n_rays, n_steps, ray_offset=offset)
    got = p_rng.jitter_table(seed, n_rays, n_steps, ray_offset=offset)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_mix_seed_py_equal():
    states = [0, 1, 42, 0xDEADBEEF, 0x123456789ABCDEF0, 2 ** 64 - 1]
    for s in states:
        assert p_rng.mix_seed_py(s) == j_rng.mix_seed_py(s)


@pytest.mark.parametrize("mode", [J.SamplingMode.FIXED,
                                  J.SamplingMode.STRATIFIED])
def test_plan_jitter_table_matches_reference(mode):
    plan, _ = scene(mode=mode)
    ref = j_pipeline.plan_jitter_table(plan)
    got = p_pipeline.plan_jitter_table(port_plan(plan))
    if ref is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, ref)
        assert not got.flags.writeable


# ---------------------------------------------------------- host geometry


GEOMETRY_SCENES = {
    "pinhole": dict(),
    "roi": dict(width=50, height=38, roi=J.Roi(x=3, y=5, width=41,
                                                  height=27)),
    "ortho_stratified": dict(mode=J.SamplingMode.STRATIFIED),
}


def _geometry_plan(name):
    plan, field = scene(**GEOMETRY_SCENES[name])
    if name == "ortho_stratified":
        cfg = plan.descriptor()
        cam = J.CameraConfig(model=J.CameraModel.ORTHOGRAPHIC, k=cfg.camera.k,
                             c2w=cfg.camera.c2w, ortho_scale=0.6)
        plan = J.Plan.create(dataclasses.replace(cfg, camera=cam))
    return plan, field


@pytest.mark.parametrize("name", sorted(GEOMETRY_SCENES))
def test_host_rays_and_windows_equal(name):
    plan, field = _geometry_plan(name)
    pplan = port_plan(plan)
    for a, b in zip(j_windowed._host_rays(plan), p_windowed._host_rays(pplan)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ref = j_windowed._windows(plan, field.bbox_min, field.bbox_max)
    got = p_windowed._windows(pplan, field.bbox_min, field.bbox_max)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].sum() > 0


@pytest.mark.parametrize("name", sorted(GEOMETRY_SCENES))
def test_roi_hitmask_equal(name):
    plan, _ = _geometry_plan(name)
    ref = np.asarray(j_windowed.roi_hitmask(plan))
    got = p_windowed.roi_hitmask(port_plan(plan), "cpu").numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------- field


def test_dense_field_create_matches_reference():
    rng = np.random.default_rng(1)
    cfg = dict(resolution=(4, 3, 2), sigma=rng.uniform(0, 1, 24),
               color=rng.uniform(0, 1, 72), bbox_min=(-1, 0, 0.5),
               bbox_max=(1, 2, 3))
    ref = J.DenseGridField.create(J.DenseGridConfig(**cfg))
    got = P.DenseGridField.create(P.DenseGridConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got.sigma.detach().numpy(),
                                  np.asarray(ref.sigma))
    np.testing.assert_array_equal(got.color.detach().numpy(),
                                  np.asarray(ref.color))
    assert got.bbox_min == ref.bbox_min and got.bbox_max == ref.bbox_max
    assert got.resolution == ref.resolution
    assert got.voxel_count == ref.voxel_count
    assert got.grid_shape == (2, 3, 4)
    assert [n for n, _ in got.named_parameters()] == ["sigma", "color"]
    carried = port_field(ref)
    assert torch.equal(carried.sigma, got.sigma)
    assert torch.equal(carried.color, got.color)


@pytest.mark.parametrize("bad", [
    dict(resolution=(2, 2, 2), sigma=np.ones(7), color=np.ones(24)),
    dict(resolution=(2, 2, 2), sigma=np.ones(8), color=np.ones(23)),
    dict(resolution=(0, 2, 2), sigma=[], color=[])])
def test_dense_field_validation_matches_reference(bad):
    with pytest.raises(J.DvrenError) as ref:
        J.DenseGridField.create(J.DenseGridConfig(**bad))
    with pytest.raises(P.DvrenError) as got:
        P.DenseGridField.create(P.DenseGridConfig(**bad), device="cpu")
    assert str(got.value) == str(ref.value)
