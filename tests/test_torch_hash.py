"""The hash-MLP field of dvren_tpu_torch against dvren_tpu, on the CPU:
the per-sample reference (ops/hashmlp.py), the field, the hash schedules,
the fused forward (K7f's plain twin) and Renderer.forward.

Same inputs through both packages: parameter blobs and positions made
with numpy from a seed, weights carried across as numpy. The JAX side
runs as its own suite runs it on the CPU: ``render_hash_tiled`` with its
Pallas kernel in interpret mode, and ``pipeline.render``. Tolerances are
the JAX package's for its own kernel (tests/test_hash_tiled.py): planes
5e-6, depth 1e-4, hitmask equal; schedules equal array for array. The
gradients and the fit are in tests/test_torch_hash_grad.py;
tests/test_torch_cuda.py holds the CUDA kernels to the twins on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.hash_mlp import HashMLPConfig as JConfig
from dvren_tpu.fields.hash_mlp import HashMLPField as JField
from dvren_tpu.ops import hash_tiles as j_ht
from dvren_tpu.ops import hashmlp as j_ops
from dvren_tpu.render import hash_tiled as j_hash
from dvren_tpu.render.pipeline import render as j_render
from tests.test_torch_core import port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import hash_tiles as p_ht
from dvren_tpu_torch.ops import hashmlp as p_ops
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.render import hash_tiled as p_hash
from dvren_tpu_torch.render import renderer as p_renderer

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
SPEC8 = dict(n_levels=8, table_size=128, base_resolution=2.0,
             finest_resolution=48.0)    # the fit benchmark's spec


def j_spec(name="default"):
    return j_ops.HashMLPSpec(**(SPEC8 if name == "l8" else {}))


def p_spec(name="default"):
    return P.HashMLPSpec(**(SPEC8 if name == "l8" else {}))


def blob(spec, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, spec.param_count).astype(np.float32)


def port_hash_field(jf, spec) -> "P.HashMLPField":
    return P.HashMLPField.from_reference_params(
        {k: np.asarray(v) for k, v in jf.params.items()}, spec,
        device="cpu")


def make_plan(w=24, h=20, mode=J.SamplingMode.FIXED, roi=None, seed=0):
    """tests/test_hash_tiled.py::make_plan."""
    return J.Plan.create(J.PlanConfig(
        width=w, height=h, t_near=0.2, t_far=1.8, seed=seed,
        roi=roi if roi is not None else J.Roi(),
        sampling=J.SamplingConfig(dt=0.05, max_steps=24, mode=mode)))


# (plan kwargs, field seed or None for all zeros, spec)
CASES = {
    "fixed": (dict(), 0, "default"),
    "stratified": (dict(mode=J.SamplingMode.STRATIFIED, seed=11), 5,
                   "default"),
    "roi": (dict(w=40, h=24, roi=J.Roi(x=3, y=2, width=21, height=17)), 7,
            "default"),
    "l8": (dict(mode=J.SamplingMode.STRATIFIED, seed=3), 1, "l8"),
    "zeros": (dict(mode=J.SamplingMode.STRATIFIED, seed=3), None,
              "default"),
}


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX plan, JAX field, port plan, port field) of one case."""
    plan_kw, seed, spec_name = CASES[name]
    spec = j_spec(spec_name)
    plan = make_plan(**plan_kw)
    jf = JField.create(JConfig(
        spec=spec, params=None if seed is None else blob(spec, seed)))
    return plan, jf, port_plan(plan), port_hash_field(jf, p_spec(spec_name))


@functools.lru_cache(maxsize=None)
def j_tiled(name):
    plan, jf, _, _ = case(name)
    return jax.jit(lambda f, s: j_hash.render_hash_tiled(plan, f, s))(
        jf, j_hash.build_hash_schedule(plan))


@functools.lru_cache(maxsize=None)
def j_pipeline(name):
    plan, jf, _, _ = case(name)
    return jax.jit(lambda f: j_render(plan, f).planes)(jf)


def assert_planes_close(got, ref, tol=TOL):
    for key in ("image", "opacity", "transmittance"):
        np.testing.assert_allclose(np.asarray(getattr(got, key)),
                                   np.asarray(getattr(ref, key)), atol=tol,
                                   err_msg=key)
    np.testing.assert_allclose(np.asarray(got.depth), np.asarray(ref.depth),
                               atol=TOL_DEPTH)
    np.testing.assert_array_equal(np.asarray(got.hitmask),
                                  np.asarray(ref.hitmask))


class _Np:
    """ImagePlanes of tensors as numpy."""

    def __init__(self, planes):
        for key in ("image", "opacity", "transmittance", "depth", "hitmask"):
            setattr(self, key, getattr(planes, key).detach().numpy())


def port_render(name, use_kernel=True):
    _, _, pplan, pf = case(name)
    sched = p_hash.build_hash_schedule(pplan, device="cpu")
    with torch.no_grad():
        return _Np(p_hash.render_hash_tiled(pplan, pf, sched,
                                            use_kernel=use_kernel))


# ------------------------------------------------------------ ops/hashmlp.py


@pytest.mark.parametrize("t_size", [16, 128, 100])
def test_hash_coords_equal(t_size):
    rng = np.random.default_rng(4)
    ints = rng.integers(-3000, 3000, (3, 500)).astype(np.int32)
    extremes = np.array([[-2 ** 31, 2 ** 31 - 1, -1, 0, 1]] * 3, np.int32)
    ints = np.concatenate([ints, extremes], axis=1)
    want = np.asarray(j_ops.hash_coords(*(jnp.asarray(v) for v in ints),
                                        t_size))
    got = p_ops.hash_coords(*(torch.from_numpy(v) for v in ints), t_size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("spec_name", ["default", "l8"])
def test_encode_and_heads_match(spec_name):
    js, ps = j_spec(spec_name), p_spec(spec_name)
    params_np = {k: np.asarray(v) for k, v in
                 j_ops.unpack_params(jnp.asarray(blob(js, 3)), js).items()}
    jp = {k: jnp.asarray(v) for k, v in params_np.items()}
    pp = {k: torch.from_numpy(np.array(v)) for k, v in params_np.items()}
    pos = np.random.default_rng(5).uniform(-0.3, 1.3, (97, 3)).astype(
        np.float32)
    jpos, ppos = jnp.asarray(pos), torch.from_numpy(pos)

    np.testing.assert_allclose(
        p_ops.encode(ppos, pp["hash_table"], ps).numpy(),
        np.asarray(j_ops.encode(jpos, jp["hash_table"], js)), atol=1e-6)
    np.testing.assert_allclose(p_ops.eval_sigma(ppos, pp, ps).numpy(),
                               np.asarray(j_ops.eval_sigma(jpos, jp, js)),
                               atol=1e-6)
    np.testing.assert_allclose(p_ops.eval_color(ppos, pp, ps).numpy(),
                               np.asarray(j_ops.eval_color(jpos, jp, js)),
                               atol=1e-6)
    got = p_ops.eval_planes(ppos[:, 0], ppos[:, 1], ppos[:, 2], pp, ps)
    want = j_ops.eval_planes(jpos[:, 0], jpos[:, 1], jpos[:, 2], jp, js)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("spec_name", ["default", "l8"])
def test_pack_unpack_round_trip(spec_name):
    js, ps = j_spec(spec_name), p_spec(spec_name)
    flat = blob(js, 6)
    jp = j_ops.unpack_params(jnp.asarray(flat), js)
    pp = p_ops.unpack_params(flat, ps)
    assert set(pp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]), k)
    np.testing.assert_array_equal(p_ops.pack_params(pp, ps).numpy(), flat)
    np.testing.assert_array_equal(
        p_ht.pack_mlp_scalars(pp, ps).numpy(),
        np.asarray(j_ht.pack_mlp_scalars(jp, js)))
    assert p_ht._mlp_layout(ps) == j_ht._mlp_layout(js)
    # grads_from_blocks inverts the packing
    back = p_ht.grads_from_blocks(pp["hash_table"].reshape(-1),
                                  p_ht.pack_mlp_scalars(pp, ps), ps)
    for k in jp:
        np.testing.assert_array_equal(back[k].numpy(), pp[k].numpy(), k)


@pytest.mark.parametrize("kw", [dict(), SPEC8,
                                dict(n_levels=4, resolutions=(4, 8, 16, 32)),
                                dict(n_levels=1)])
def test_level_resolutions_and_fast_path_equal(kw):
    js, ps = j_ops.HashMLPSpec(**kw), P.HashMLPSpec(**kw)
    assert p_ops.level_resolutions(ps) == j_ht.level_resolutions(js)
    assert p_ht.fast_path_ok(ps) == j_ht.fast_path_ok(js)
    assert ps.param_count == js.param_count


def test_fast_path_rules():
    assert p_ht.fast_path_ok(P.HashMLPSpec(table_size=128))
    assert not p_ht.fast_path_ok(P.HashMLPSpec(table_size=100))
    assert not p_ht.fast_path_ok(P.HashMLPSpec(table_size=256))
    assert not p_ht.fast_path_ok(P.HashMLPSpec(hidden_dim=16))


# ------------------------------------------------------------------- field


def test_field_construction():
    spec = P.HashMLPSpec()
    zero = P.HashMLPField.create(P.HashMLPConfig(), device="cpu")
    assert float(zero.flat_params().detach().abs().sum()) == 0.0
    assert tuple(zero.params["hash_table"].shape) == (4, 16, 2)
    assert zero.params["sigma_b2"].dim() == 0
    flat = blob(spec, 8)
    f = P.HashMLPField.create(P.HashMLPConfig(params=flat), device="cpu")
    np.testing.assert_array_equal(f.flat_params().detach().numpy(), flat)
    assert f.device == torch.device("cpu") and f.to("cpu") is f
    with pytest.raises(P.DvrenError):
        P.HashMLPField.create(P.HashMLPConfig(params=flat[:-1]),
                              device="cpu")
    # parameters are what an optimizer trains; with_params shares them
    assert len(list(f.parameters())) == 9
    g = f.with_params(dict(f.params))
    assert g.params["hash_table"] is f.params["hash_table"]
    r1 = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                    device="cpu")
    r2 = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                    device="cpu")
    for k in r1.params:
        assert torch.equal(r1.params[k], r2.params[k]), k
    assert float(r1.params["sigma_w1"].detach().abs().sum()) > 0.0
    assert float(r1.params["sigma_b1"].detach().abs().sum()) == 0.0


def test_field_point_eval_matches_reference():
    _, jf, _, pf = case("stratified")
    pos = np.random.default_rng(9).uniform(0, 1, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pf.sigma_at(torch.from_numpy(pos)).detach().numpy(),
        np.asarray(jf.sigma_at(jnp.asarray(pos))), atol=1e-6)
    np.testing.assert_allclose(
        pf.color_at(torch.from_numpy(pos)).detach().numpy(),
        np.asarray(jf.color_at(jnp.asarray(pos))), atol=1e-6)


# --------------------------------------------------------------- schedules


def _assert_schedule_equal(got, want):
    assert (got.n_chunks, got.n_tiles) == (want.n_chunks, want.n_tiles)
    # sample_t: the TPU's u16 hi | lo halves, recombined
    bits = ((np.asarray(want.samp[:, :, 0]).astype(np.uint32) << 16)
            | np.asarray(want.samp[:, :, 1]).astype(np.uint32))
    assert got.samp.dtype == np.float32
    np.testing.assert_array_equal(got.samp.view(np.uint32), bits)
    np.testing.assert_array_equal(got.rayt, np.asarray(want.rayt))
    np.testing.assert_array_equal(got.tile_ids, np.asarray(want.tile_ids))


@pytest.mark.parametrize("name", ["fixed", "stratified", "roi"])
def test_hash_schedule_equal(name):
    plan, _, pplan, _ = case(name)
    want = j_hash.build_hash_schedule(plan, device=False)
    got = p_hash.build_hash_schedule(pplan)
    _assert_schedule_equal(got, want)
    assert got.device is None
    moved = got.to("cpu")
    assert moved.device == torch.device("cpu")
    assert torch.equal(moved.samp, torch.from_numpy(got.samp))


def test_hash_schedule_stack_equal():
    from dvren_tpu.opt.fit import view_plans as j_view_plans

    plan, _, pplan, _ = case("stratified")
    cams = [J.CameraConfig(k=plan.camera.k,
                           c2w=(1, 0, 0, 0.5 + 0.1 * v, 0, 1, 0, 0.5, 0, 0,
                                1, -1.0 - 0.2 * v))
            for v in range(3)]
    want = j_hash.build_hash_schedule_stack(j_view_plans(plan, cams))
    got = p_hash.build_hash_schedule_stack(
        p_fit.view_plans(pplan, [P.CameraConfig(k=c.k, c2w=c.c2w)
                                 for c in cams]))
    assert got.n_views == want.n_views == 3
    _assert_schedule_equal(got, want)


# ------------------------------------------------------------ fused forward


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_reference(name):
    """The plain twin of K7f, composed, against JAX's render_hash_tiled
    (its Pallas kernel in interpret mode) and pipeline.render."""
    got = port_render(name)
    assert_planes_close(got, j_tiled(name))
    assert_planes_close(got, j_pipeline(name))
    if name == "roi":
        outside = np.ones(got.image.shape[:2], bool)
        outside[2:2 + 17, 3:3 + 21] = False
        assert np.all(got.image[outside] == 0.0)
    if name == "zeros":
        assert float(np.abs(got.opacity).max()) == 0.0


def test_wrapper_on_cpu_is_the_plain_twin():
    before = p_ht.hash_tile_forward.launches
    a = port_render("stratified")
    b = port_render("stratified", use_kernel=False)
    assert p_ht.hash_tile_forward.launches == before
    for key in ("image", "opacity", "transmittance", "depth"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


def test_forward_inputs_checked():
    _, _, pplan, pf = case("fixed")
    sched = p_hash.build_hash_schedule(pplan, device="cpu")
    prm = p_ht.hash_tile_params(pplan, pf.spec, sched.n_chunks)
    table = pf.params["hash_table"].detach()
    sc = p_ht.pack_mlp_scalars(dict(pf.params), pf.spec).detach()
    with pytest.raises(ValueError):
        p_ht.hash_tile_forward(sched.samp[:, :1], sched.rayt, table, sc, prm)
    with pytest.raises(TypeError):
        p_ht.hash_tile_forward(sched.samp.double(), sched.rayt, table, sc,
                               prm)
    with pytest.raises(P.DvrenError):       # still numpy: not on the device
        p_hash.render_hash_tiled(pplan, pf, p_hash.build_hash_schedule(pplan))


# ----------------------------------------------------------------- Renderer


def hash_renderer(pplan, options=None):
    return P.Renderer(P.Context.create(device="cpu"), pplan,
                      options or P.RenderOptions(use_tiles=True))


@pytest.mark.parametrize("name", ["stratified", "roi"])
def test_renderer_forward_matches(name):
    plan, _, pplan, pf = case(name)
    renderer = hash_renderer(pplan)
    res = renderer.forward(pf)
    h, w = plan.height, plan.width
    ref = j_tiled(name)
    np.testing.assert_allclose(res.image.reshape(h, w, 3),
                               np.asarray(ref.image), atol=TOL)
    np.testing.assert_allclose(res.opacity.reshape(h, w),
                               np.asarray(ref.opacity), atol=TOL)
    np.testing.assert_allclose(res.depth.reshape(h, w),
                               np.asarray(ref.depth), atol=TOL_DEPTH)
    np.testing.assert_array_equal(res.hitmask.reshape(h, w),
                                  np.asarray(ref.hitmask))
    np.testing.assert_array_equal(res.image.reshape(h, w, 3),
                                  port_render(name).image)
    notes = res.stats.notes
    assert "hash_tiled_path" in notes
    assert "kernel_launches=hash_tiles:0" in notes
    assert any(n.startswith("hash_schedule_build_ms=") for n in notes)
    # the schedule is frame layout: built once per plan, for any field
    again = renderer.forward(pf)
    assert not any(n.startswith("hash_schedule_build_ms=")
                   for n in again.stats.notes)
    np.testing.assert_array_equal(again.image, res.image)
    assert res.ray_count == plan.ray_count


def test_renderer_hash_modes():
    _, _, pplan, pf = case("fixed")
    with pytest.raises(NotImplementedError):       # auto on a CPU context
        hash_renderer(pplan, P.RenderOptions()).forward(pf)
    with pytest.raises(NotImplementedError):
        hash_renderer(pplan, P.RenderOptions(use_tiles=False)).forward(pf)
    with pytest.raises(NotImplementedError):
        hash_renderer(pplan, P.RenderOptions(use_tiles=True,
                                             enable_graph=True)).forward(pf)
    ineligible = P.HashMLPField.create(P.HashMLPConfig(
        spec=P.HashMLPSpec(table_size=100)), device="cpu")
    with pytest.raises(P.DvrenError):       # not a dense grid either
        hash_renderer(pplan).forward(ineligible)


def test_renderer_backward_on_hash_field_refuses():
    _, _, pplan, pf = case("fixed")
    renderer = hash_renderer(pplan)
    renderer.forward(pf)
    with pytest.raises(P.DvrenError, match="hash-MLP"):
        renderer.backward(pf, np.zeros(pplan.ray_count * 3, np.float32))


def test_field_without_sigma_is_routed_not_attribute_error():
    """Renderer.forward read field.sigma.device before routing: any field
    without ``sigma`` died with AttributeError."""
    _, _, pplan, _ = case("fixed")

    class Bare:
        pass

    with pytest.raises(NotImplementedError):
        hash_renderer(pplan, P.RenderOptions()).forward(Bare())
    with pytest.raises(P.DvrenError):
        hash_renderer(pplan).forward(Bare())


def test_launch_counts_include_k7():
    counts = p_renderer._launch_counts()
    assert len(counts) == 3
    assert counts[2] == p_ht.hash_tile_forward.launches
