"""The Renderer's general paths of dvren_tpu_torch against dvren_tpu's, on
the CPU: the staged, fused and streamed modes with their backward, fields
the tiles refuse (nearest interpolation, clamp OOB), the parity views
(``per_sample_gradients``, ``packed_aux``, ``packed_samples``,
``last_outputs``), ``workspace_info``, and a hash-MLP field through
``pipeline.render`` and the Renderer's fused and streamed modes.

Same seeded inputs through both packages, on tests/test_core_threeway.py's
scene (10x8 rays over a 6^3 grid, 32 steps; stratified and fixed). The
JAX side runs its Renderer with the same options on the CPU (its default
off a TPU is this path). Held: planes within 5e-6 (depth 1e-4) and the
hitmask and sample counts equal; grid gradients within 2e-6 x scale;
camera gradients within rtol 2e-3 / atol 1e-4; per-sample views within
2e-6 x scale with their counts and ``ray_offset`` equal; the hash field's
planes within 5e-6 (depth 1e-4). ``per_sample_gradients`` is also checked
by central differences of the radiance head in float64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.hash_mlp import HashMLPConfig as JHashConfig
from dvren_tpu.fields.hash_mlp import HashMLPField as JHashField
from dvren_tpu.ops import hashmlp as j_hashmlp
from dvren_tpu.render.pipeline import render as j_render
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops.integrate import radiance_only
from dvren_tpu_torch.render import pipeline as p_pipe

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
GRID_TOL = 2e-6     # x max |reference|
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4

MODES = {"fused": dict(use_fused_path=True),
         "staged": dict(use_fused_path=False),
         "streamed": dict(streaming=True)}


@functools.lru_cache(maxsize=None)
def scene(sampling="stratified", interp="linear", oob="zero"):
    """tests/test_core_threeway.py's scene: (JAX plan, JAX field, dL/dI)."""
    rng = np.random.default_rng(7)
    n = 6
    mode = (J.SamplingMode.STRATIFIED if sampling == "stratified"
            else J.SamplingMode.FIXED)
    plan = J.Plan.create(J.PlanConfig(
        width=10, height=8, t_near=0.3, t_far=2.1, seed=9,
        camera=J.CameraConfig(
            k=(12.0, 0, 5.0, 0, 12.0, 4.0, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -0.9)),
        sampling=J.SamplingConfig(dt=0.06, max_steps=32, mode=mode)))
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0.1, 1.0, 3 * n ** 3),
        bbox_min=(0.1, 0.05, 0.0) if oob == "clamp" else (0.0, 0.0, 0.0),
        bbox_max=(0.9, 0.95, 1.0) if oob == "clamp" else (1.0, 1.0, 1.0),
        interp=(J.InterpMode.NEAREST if interp == "nearest"
                else J.InterpMode.LINEAR),
        oob=J.OobPolicy.CLAMP if oob == "clamp" else J.OobPolicy.ZERO))
    dl = rng.uniform(-1, 1, (plan.ray_count, 3)).astype(np.float32)
    return plan, field, dl


@functools.lru_cache(maxsize=None)
def j_run(options, *scene_key):
    """The JAX Renderer's forward, backward and parity views."""
    plan, field, dl = scene(*scene_key)
    r = J.Renderer(J.Context.create(), plan, J.RenderOptions(**dict(options)))
    fwd = r.forward(field)
    bwd = r.backward(field, dl)
    views = dict(r.packed_samples(), aux=r.packed_aux())
    views["d_sigma"], views["d_color"] = r.per_sample_gradients(dl)
    return fwd, bwd, views, r._last_mode


def p_renderer(plan, options):
    return P.Renderer(P.Context.create(device="cpu"), port_plan(plan),
                      P.RenderOptions(**options))


def close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * scale, err_msg=what)


def assert_forward_close(got, ref):
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   atol=TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(got.depth, ref.depth, atol=TOL_DEPTH, rtol=0)
    np.testing.assert_array_equal(got.hitmask, ref.hitmask)
    assert (got.ray_count, got.sample_count) == (ref.ray_count,
                                                 ref.sample_count)


def assert_backward_close(got, ref):
    close(got.sigma, ref.sigma, GRID_TOL, "sigma")
    close(got.color, ref.color, GRID_TOL, "color")
    for key in ("camera", "camera_k"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key),
                                   rtol=CAM_RTOL, atol=CAM_ATOL, err_msg=key)
    assert got.sample_count == ref.sample_count


def assert_views_close(got, ref):
    np.testing.assert_array_equal(got["ray_offset"], ref["ray_offset"])
    for key in ("positions", "dt", "sigma", "color", "aux", "d_sigma",
                "d_color"):
        assert got[key].shape == ref[key].shape, key
        close(got[key], ref[key], GRID_TOL, key)


def p_views(r, dl):
    views = dict(r.packed_samples(), aux=r.packed_aux())
    views["d_sigma"], views["d_color"] = r.per_sample_gradients(dl)
    return views


@pytest.mark.parametrize("sampling", ["stratified", "fixed"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_forward_backward_match_jax(mode, sampling):
    plan, field, dl = scene(sampling)
    ref_f, ref_b, _, ref_mode = j_run(tuple(MODES[mode].items()), sampling)
    r = p_renderer(plan, MODES[mode])
    pf = port_field(field)
    got_f = r.forward(pf)
    assert r._last_mode == ref_mode
    assert_forward_close(got_f, ref_f)
    note = {"fused": "fused_path", "staged": "staged_path",
            "streamed": "streaming_path"}[mode]
    assert note in got_f.stats.notes
    assert_backward_close(r.backward(pf, dl), ref_b)


def test_staged_and_fused_frames_equal_and_stats_filled():
    plan, field, _ = scene()
    pf = port_field(field)
    staged = p_renderer(plan, MODES["staged"]).forward(pf)
    fused = p_renderer(plan, MODES["fused"]).forward(pf)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        np.testing.assert_array_equal(getattr(staged, key),
                                      getattr(fused, key))
    st = staged.stats
    assert min(st.ray_ms, st.sample_ms, st.integrate_ms, st.compose_ms) > 0
    quiet = p_renderer(plan, dict(use_fused_path=False,
                                  capture_stats=False)).forward(pf)
    assert quiet.stats.integrate_ms == 0.0
    np.testing.assert_array_equal(quiet.image, staged.image)


@pytest.mark.parametrize("case", [("stratified", "nearest", "zero"),
                                  ("fixed", "linear", "clamp"),
                                  ("stratified", "nearest", "clamp")])
def test_fields_the_tiles_refuse_take_the_general_path(case):
    """Nearest and clamp fields under the default options on a CPU
    context: the fused path, forward and backward as JAX's."""
    plan, field, dl = scene(*case)
    ref_f, ref_b, _, _ = j_run((), *case)
    r = p_renderer(plan, {})
    pf = port_field(field)
    assert_forward_close(r.forward(pf), ref_f)
    assert r._last_mode == "fused"
    assert_backward_close(r.backward(pf, dl), ref_b)


@pytest.mark.parametrize("mode", ["fused", "staged", "streamed",
                                  "windowed", "tiled"])
def test_parity_views_match_jax(mode):
    """The views of every mode against JAX's fused views (JAX's are the
    same in every mode, tests/test_renderer_streaming.py); within the port
    a recomputed view equals the fused one bit for bit."""
    plan, field, dl = scene()
    _, _, ref, _ = j_run(tuple(MODES["fused"].items()))
    options = MODES.get(mode) or (dict(use_window=True) if mode == "windowed"
                                  else dict(use_tiles=True))
    r = p_renderer(plan, options)
    pf = port_field(field)
    r.forward(pf)
    got = p_views(r, dl)
    assert_views_close(got, ref)
    assert int(got["ray_offset"][-1]) == r.forward(pf).sample_count
    if mode != "fused":
        base = p_renderer(plan, MODES["fused"])
        base.forward(pf)
        want = p_views(base, dl)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_last_outputs_and_views_need_a_forward():
    plan, field, _ = scene()
    r = p_renderer(plan, MODES["fused"])
    for call in (r.packed_samples, r.packed_aux,
                 lambda: r.per_sample_gradients(np.zeros(240, np.float32))):
        with pytest.raises(P.DvrenError, match="prior Forward"):
            call()
    assert r.last_outputs is None
    r.forward(port_field(field))
    out = r.last_outputs
    assert out.lattice.mask.shape == (plan.ray_count, 32)
    assert out.intl.aux is None             # K9f's route keeps no aux
    streamed = p_renderer(plan, MODES["streamed"])
    streamed.forward(port_field(field))
    assert streamed.last_outputs is None


def test_per_sample_gradients_finite_difference():
    """``per_sample_gradients`` against central differences (eps 1e-3) of
    the radiance head in float64 on the last lattice, at live samples
    (tests/test_backward_fd.py's gate: rel 1e-2 or abs 1e-4)."""
    plan, field, dl = scene()
    r = p_renderer(plan, MODES["fused"])
    r.forward(port_field(field))
    d_sigma, d_color = r.per_sample_gradients(dl)
    out = r.last_outputs
    mask = out.lattice.mask
    sig = out.sigma.double()
    col = torch.stack(out.color, dim=-1).double()
    dt = out.lattice.dt.double()
    g = torch.from_numpy(dl).double()

    def loss(s, c):
        return float(torch.sum(radiance_only(s, c, dt, mask) * g))

    live = torch.nonzero(mask)
    eps = 1e-3
    for j in (0, 7, 311, 1200, live.shape[0] - 1):
        r_, i = (int(v) for v in live[j])
        e = torch.zeros_like(sig)
        e[r_, i] = eps
        fd = (loss(sig + e, col) - loss(sig - e, col)) / (2 * eps)
        assert (abs(d_sigma[j] - fd) <= 1e-2 * max(abs(fd), 1e-4)
                or abs(d_sigma[j] - fd) < 1e-4), (j, d_sigma[j], fd)
        for c in range(3):
            e = torch.zeros_like(col)
            e[r_, i, c] = eps
            fd = (loss(sig, col + e) - loss(sig, col - e)) / (2 * eps)
            assert (abs(d_color[j, c] - fd) <= 1e-2 * max(abs(fd), 1e-4)
                    or abs(d_color[j, c] - fd) < 1e-4), (j, c)


@pytest.mark.parametrize("options", [dict(), dict(streaming=True),
                                     dict(use_window=True)])
def test_workspace_info_matches_jax(options):
    plan, _, _ = scene()
    ref = J.Renderer(J.Context.create(), plan,
                     J.RenderOptions(**options)).workspace_info()
    got = p_renderer(plan, options).workspace_info()
    for key in ("ray_buffer_bytes", "sample_buffer_bytes",
                "integration_buffer_bytes", "image_buffer_bytes",
                "gradient_buffer_bytes", "workspace_buffer_bytes"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.total_bytes() == ref.total_bytes()


def test_streaming_auto_selection_matches_jax():
    """``ray_count * max_steps > streaming_budget`` picks the streamed
    path, as in JAX (renderer.py:175-179)."""
    plan, field, _ = scene()
    for budget in (10, 1 << 22):
        options = dict(streaming_budget=budget)
        jr = J.Renderer(J.Context.create(), plan, J.RenderOptions(**options))
        r = p_renderer(plan, options)
        r.forward(port_field(field))
        assert r._streaming == jr._streaming
        assert r._last_mode == ("streamed" if jr._streaming else "fused")


# ------------------------------------------------------ a hash-MLP field

HASH_SPEC = dict(n_levels=4, table_size=64, base_resolution=2.0,
                 finest_resolution=16.0)


@functools.lru_cache(maxsize=None)
def hash_case():
    plan = J.Plan.create(J.PlanConfig(
        width=12, height=10, t_near=0.2, t_far=1.8, seed=5,
        sampling=J.SamplingConfig(dt=0.05, max_steps=24,
                                  mode=J.SamplingMode.STRATIFIED)))
    spec = j_hashmlp.HashMLPSpec(**HASH_SPEC)
    rng = np.random.default_rng(2)
    jf = JHashField.create(JHashConfig(
        spec=spec, params=rng.uniform(-0.5, 0.5, spec.param_count).astype(
            np.float32)))
    pf = P.HashMLPField.from_reference_params(
        {k: np.asarray(v) for k, v in jf.params.items()},
        P.HashMLPSpec(**HASH_SPEC), device="cpu")
    ref = jax.jit(lambda f: j_render(plan, f).planes)(jf)
    return plan, jf, pf, ref


def assert_planes_close(got, ref):
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, key)).reshape(-1),
            np.asarray(getattr(ref, key)).reshape(-1), atol=TOL, rtol=0,
            err_msg=key)
    np.testing.assert_allclose(np.asarray(got.depth).reshape(-1),
                               np.asarray(ref.depth).reshape(-1),
                               atol=TOL_DEPTH, rtol=0)
    np.testing.assert_array_equal(np.asarray(got.hitmask).reshape(-1),
                                  np.asarray(ref.hitmask).reshape(-1))


def test_hash_field_through_pipeline_render_matches_jax():
    plan, _, pf, ref = hash_case()
    with torch.no_grad():
        got = p_pipe.render(port_plan(plan), pf).planes
    assert_planes_close(
        type("N", (), {k: getattr(got, k).numpy() for k in
                       ("image", "transmittance", "opacity", "depth",
                        "hitmask")}), ref)


def test_hash_field_planes_evaluation_matches_jax():
    plan, jf, pf, _ = hash_case()
    rng = np.random.default_rng(8)
    pts = [rng.uniform(-0.2, 1.2, (7, 9)).astype(np.float32)
           for _ in range(3)]
    ref = jax.jit(lambda f, *p: (f.sigma_at_planes(*p),)
                  + tuple(f.color_at_planes(*p)))(jf, *map(jnp.asarray, pts))
    tp = [torch.from_numpy(p) for p in pts]
    got = (pf.sigma_at_planes(*tp),) + tuple(pf.color_at_planes(*tp))
    packed = pf.packed_eval_planes(*tp)
    assert pf.supports_packed_eval
    for a, b, c in zip(got, packed, ref):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
        close(a.detach().numpy(), np.asarray(c), 1e-6)


@pytest.mark.parametrize("options", [dict(), dict(use_tiles=False),
                                     dict(use_tiles=False, streaming=True)])
def test_hash_renderer_general_paths_match_jax(options):
    """A hash field on a CPU context: the default and ``use_tiles=False``
    take the fused path, and with ``streaming`` the streamed one; the
    backward refuses there, as JAX's does."""
    plan, jf, pf, _ = hash_case()
    ref = J.Renderer(J.Context.create(), plan,
                     J.RenderOptions(**options)).forward(jf)
    r = p_renderer(plan, options)
    got = r.forward(pf)
    assert r._last_mode == ("streamed" if options.get("streaming")
                            else "fused")
    assert_forward_close(got, ref)
    with pytest.raises(P.DvrenError, match="hash-MLP"):
        r.backward(pf, np.zeros(plan.ray_count * 3, np.float32))


@pytest.mark.parametrize("mode", ["fused", "streamed"])
def test_sparse_field_backward_refused_on_the_general_paths(mode):
    """JAX's backward takes a sparse field on its tiled path only
    (renderer.py:793-807); the fused and streamed modes refuse it."""
    plan, field, dl = scene()
    sp = P.SparseGridField.from_dense(port_field(field), threshold=0.0,
                                      device="cpu")
    r = p_renderer(plan, MODES[mode])
    dense = p_renderer(plan, MODES[mode]).forward(port_field(field))
    got = r.forward(sp)
    np.testing.assert_allclose(got.image, dense.image, atol=TOL, rtol=0)
    with pytest.raises(P.DvrenError, match="sparse brick fields on the tiled"):
        r.backward(sp, dl)
