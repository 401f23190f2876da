"""16-bit packed tables and sparse brick fields of dvren_tpu_torch against
dvren_tpu, on the CPU.

Same seeded inputs through both packages: tests/test_tiled.py::scene (48x32
rays over 8^3) for the dense 16-bit route, tests/test_sparse_grid.py's
blob_field (20^3, compact and not) for sparse fields, rendered at 48x32 in
16 px tiles without overflow. The JAX side runs as its own suite does on
the CPU: K5a/K5b in interpret mode, and ``render_tiled(use_kernel=False)``
as the referee. Held:

- the 16-bit tables, K5b's twin, bricks, occupancy, sparse schedules and
  gather plans equal to dvren_tpu's, array for array;
- forward planes within 5e-6 (depth 1e-4); the sparse f32 frame equal to
  the dense f32 frame at threshold 0;
- sparse f32 d(bricks) within 2e-6 x scale of ``jax.grad``, and within
  rtol 1e-4 / atol 1e-6 of the JAX suite's pipeline referee;
- the 16-bit gradients within c * ulp x scale of ``jax.grad``, with ulp
  the 16-bit type's (2^-8 bfloat16, 2^-11 float16) and c the schedule's
  largest slot class: JAX sums a cell's slot rows in the 16-bit type in
  scatter order, the port in f32 rounded once (measured on these scenes,
  x scale: bfloat16 d_sigma 1.01e-3, d_color 6.53e-4, d(bricks) 3.21e-3;
  float16 d_sigma 0, d_color 8.15e-5; c = 3 dense, 7 sparse);
- given the same slot rows, the port's 16-bit table gradient equal to
  JAX's transpose of ``take(...).astype(float32)`` on every cell with a
  single slot, and within c * ulp elsewhere.

Also the repairs: field constructors without a device follow Context's
rule (CUDA, else DvrenError), and a Renderer keys sparse schedules by
occupancy contents. tests/test_torch_cuda.py holds K5a and K5b to their
twins on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse
from dvren_tpu.ops import grid as j_grid
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table, render
from tests.test_sparse_grid import blob_field
from tests.test_tiled import scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.fields import sparse_grid as p_sparse
from dvren_tpu_torch.ops import grid as p_grid
from dvren_tpu_torch.ops import packed_transpose as p_pt
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
GRID_TOL = 2e-6       # x max |reference|
ULP16 = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
DTYPES16 = ("bfloat16", "float16")


def close(got, ref, tol):
    """|got - ref| <= tol * max |ref|."""
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * scale)


def planes_close(got, ref):
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key).detach().numpy(),
                                   np.asarray(getattr(ref, key)), atol=TOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(got.depth.detach().numpy(),
                               np.asarray(ref.depth), atol=TOL_DEPTH, rtol=0)
    np.testing.assert_array_equal(got.hitmask.numpy(),
                                  np.asarray(ref.hitmask))


def all_heads_jax(pls):
    return (jnp.mean(pls.image ** 2) + 0.1 * jnp.mean(pls.opacity)
            + 0.01 * jnp.mean(pls.depth))


def all_heads_port(pls):
    return (torch.mean(pls.image ** 2) + 0.1 * torch.mean(pls.opacity)
            + 0.01 * torch.mean(pls.depth))


def sparse_plan(width=48, height=32):
    """tests/test_sparse_grid.py's tiled plan with a longer focal length
    (2.5 x width) and stratified steps, so no 16 px tile overflows (the
    tests here hold the tiles alone)."""
    return J.Plan.create(J.PlanConfig(
        width=width, height=height, t_near=0.2, t_far=2.6, seed=7,
        camera=J.CameraConfig(
            k=(width * 2.5, 0, width / 2, 0, width * 2.5, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.3, 0, 1, 0, 0.3, 0, 0, 1, -1.0)),
        sampling=J.SamplingConfig(dt=0.04, max_steps=60,
                                  mode=J.SamplingMode.STRATIFIED)))


@functools.lru_cache(maxsize=None)
def dense16(dtype):
    """(JAX plan, JAX 16-bit field, JAX schedule, port plan, port field,
    port CPU schedule) on the stratified test scene."""
    plan, field = scene(mode=J.SamplingMode.STRATIFIED)
    jf = field.with_packed_dtype(dtype)
    jsched = j_tiled.build_tiled_schedule(plan, jf,
                                          jitter=plan_jitter_table(plan))
    pplan = port_plan(plan)
    pf = port_field(field).with_packed_dtype(dtype)
    return plan, jf, jsched, pplan, pf, p_tiled.build_tiled_schedule(
        pplan, pf).to("cpu")


@functools.lru_cache(maxsize=None)
def sparse(compact=False, threshold=0.0, dtype="float32"):
    """(JAX plan, JAX dense, JAX sparse, port plan, port sparse) over the
    20^3 blob."""
    plan = sparse_plan()
    dense = blob_field(compact=compact)
    js = JSparse.from_dense(dense, threshold=threshold, dtype=dtype)
    ps = P.SparseGridField.from_dense(port_field(dense), threshold=threshold,
                                      dtype=dtype, device="cpu")
    return plan, dense, js, port_plan(plan), ps


@functools.lru_cache(maxsize=None)
def sparse_schedules(dtype="float32"):
    plan, _, js, pplan, ps = sparse(dtype=dtype)
    return (j_tiled.build_tiled_schedule(plan, js,
                                         jitter=plan_jitter_table(plan)),
            p_tiled.build_tiled_schedule(pplan, ps).to("cpu"))


def max_class(schedule) -> int:
    return max(c_k for _, _, c_k in schedule.gather_plan.meta)


# --------------------------------------------------------------- the tables


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16",
                                  "float64", "int8"])
def test_table_dtype_matches_reference(name):
    if name in ("float64", "int8"):
        with pytest.raises(J.DvrenError) as ref:
            j_grid.table_dtype(name)
        with pytest.raises(P.DvrenError) as got:
            p_grid.table_dtype(name)
        assert str(got.value) == str(ref.value)
    else:
        assert p_grid.table_dtype(name) == getattr(torch, name)
        assert str(jnp.dtype(j_grid.table_dtype(name))) == name


@pytest.mark.parametrize("dtype", DTYPES16)
@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 7, 9), (3, 17, 40)])
def test_table16_equals_reference(dtype, shape):
    """K5a's twin against JAX's 16-bit build_packed_stencil_fullpitch
    (shift stack, cast, Pallas stack_to_rows in interpret mode): equal
    bit for bit; on the CPU the wrapper runs the twin."""
    rng = np.random.default_rng(4)
    sigma = rng.uniform(-1, 300, shape).astype(np.float32)
    color = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    ref = np.asarray(j_grid.build_packed_stencil_fullpitch(
        jnp.asarray(sigma), jnp.asarray(color),
        dtype=j_grid.table_dtype(dtype))).view(np.uint16)
    before = p_pt.build_rows16.launches
    got = p_pt.build_rows16(torch.from_numpy(sigma), torch.from_numpy(color),
                            getattr(torch, dtype))
    assert p_pt.build_rows16.launches == before
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16), ref)


@pytest.mark.parametrize("dtype", DTYPES16)
def test_table16_grad_equals_reference(dtype):
    """K5b's twin against JAX's _build_fullpitch_bwd (f32 cast, Pallas
    rows_to_stack in interpret mode, stack_plane_grads) on a seeded
    16-bit cotangent: equal value for value."""
    shape = (5, 7, 9)
    rows = p_grid.fullpitch_rows(shape)
    ct = np.random.default_rng(3).normal(size=(rows, 32)).astype(np.float32)
    ct16 = jnp.asarray(ct).astype(j_grid.table_dtype(dtype))
    want = j_grid._build_fullpitch_bwd(
        dtype, (shape, shape + (3,)), ct16)
    got = p_pt.table16_grad_to_params(
        torch.from_numpy(ct).to(getattr(torch, dtype)), shape)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_table16_wrappers_reject_bad_inputs():
    sigma, color = torch.zeros((4, 4, 4)), torch.zeros((4, 4, 4, 3))
    with pytest.raises(TypeError):
        p_pt.build_rows16(sigma, color, torch.float32)
    with pytest.raises(TypeError):
        p_pt.build_rows16(sigma.double(), color.double(), torch.bfloat16)
    with pytest.raises(ValueError):
        p_pt.table16_grad_to_params(
            torch.zeros((100, 32), dtype=torch.bfloat16), (4, 4, 4))
    with pytest.raises(TypeError):
        p_pt.table16_grad_to_params(torch.zeros((2048, 32)), (4, 4, 4))


def test_dense_field_packed_dtype():
    """packed_dtype is validated, survives to() and with_params, and
    with_packed_dtype shares the parameters."""
    plan, field = scene()
    pf = port_field(field)
    assert pf.packed_dtype == "float32"
    with pytest.raises(P.DvrenError, match="unknown packed_dtype"):
        pf.with_packed_dtype("float64")
    half = pf.with_packed_dtype("bfloat16")
    assert half.packed_dtype == "bfloat16"
    assert half.sigma is pf.sigma and half.color is pf.color
    assert half.to("cpu").packed_dtype == "bfloat16"
    again = half.with_params(pf.sigma.detach() * 2, pf.color.detach())
    assert again.packed_dtype == "bfloat16"
    assert torch.equal(again.sigma, pf.sigma.detach() * 2)


# ------------------------------------------------------------ sparse field


@pytest.mark.parametrize("compact,threshold,dtype", [
    (True, 0.0, "float32"), (False, 0.0, "float32"),
    (False, 1.0, "float32"), (False, 0.0, "bfloat16"),
    (True, 1.0, "bfloat16")])
def test_from_dense_equals_reference(compact, threshold, dtype):
    _, _, js, _, ps = sparse(compact, threshold, dtype)
    assert ps.bricks.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ps.bricks.detach().float().numpy(),
                                  np.asarray(js.bricks, np.float32))
    np.testing.assert_array_equal(ps.occupancy.numpy(),
                                  np.asarray(js.occupancy))
    assert ps.grid_shape == tuple(js.grid_shape)
    assert (ps.occupied_bricks, ps.total_bricks, ps.memory_bytes()) == (
        js.occupied_bricks, js.total_bricks, js.memory_bytes())
    assert (ps.bbox_min, ps.bbox_max) == (js.bbox_min, js.bbox_max)


def test_sparse_field_construction():
    """from_reference carries the JAX arrays across (the brick type
    included); with_params shares the occupancy; bad arrays raise."""
    _, _, js, _, ps = sparse(dtype="bfloat16")
    carried = P.SparseGridField.from_reference(
        np.asarray(js.bricks), np.asarray(js.occupancy), js.grid_shape,
        js.bbox_min, js.bbox_max, device="cpu")
    assert carried.bricks.dtype == torch.bfloat16
    assert torch.equal(carried.bricks, ps.bricks)
    assert torch.equal(carried.occupancy, ps.occupancy)
    twin = ps.with_params(ps.bricks.detach() * 2)
    assert twin.occupancy is ps.occupancy and twin.grid_shape == ps.grid_shape
    assert ps.to("cpu") is ps and ps.device == torch.device("cpu")
    assert [n for n, _ in ps.named_parameters()] == ["bricks"]
    with pytest.raises(P.DvrenError):
        P.SparseGridField(ps.bricks.detach()[:, :8], ps.occupancy,
                          ps.grid_shape)
    with pytest.raises(P.DvrenError):
        P.SparseGridField(ps.bricks.detach(), ps.occupancy.long(),
                          ps.grid_shape)
    assert p_sparse.occupancy_shape((20, 20, 20)) == (3, 3, 3)


@pytest.mark.parametrize("compact", [True, False])
def test_sparse_schedule_equals_reference(compact):
    plan, _, js, pplan, ps = sparse(compact)
    ref = j_tiled.build_tiled_schedule(
        plan, js, jitter=plan_jitter_table(plan), device=False)
    got = p_tiled.build_tiled_schedule(pplan, ps)
    assert got.table_kind == "sparse" and got.fallback_rays == 0
    assert_schedules_equal(ref, got)
    gr, gp = ref.gather_plan, got.gather_plan
    assert gp.meta == tuple(gr.meta)
    for key in ("all_idx", "inv_map"):
        np.testing.assert_array_equal(getattr(gp, key),
                                      np.asarray(getattr(gr, key)))
    cells = np.random.default_rng(1).integers(0, 20 ** 3, 500)
    np.testing.assert_array_equal(
        p_tiled._sparse_rows_for_cells(cells, ps.occupancy.numpy(),
                                       ps.grid_shape),
        j_tiled._sparse_rows_for_cells(cells, np.asarray(js.occupancy),
                                       js.grid_shape))


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("dtype", DTYPES16)
def test_forward16_matches_reference(dtype):
    plan, jf, jsched, pplan, pf, sched = dense16(dtype)
    ref = j_tiled.render_tiled(plan, jf, jsched, use_kernel=False)
    with torch.no_grad():
        got = p_tiled.render_tiled(pplan, pf, sched)
        plain = p_tiled.render_tiled(pplan, pf, sched, use_kernel=False)
    planes_close(got, ref)
    assert torch.equal(got.image, plain.image)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_sparse_matches_reference(dtype):
    plan, _, js, pplan, ps = sparse(dtype=dtype)
    jsched, sched = sparse_schedules(dtype)
    ref = j_tiled.render_tiled(plan, js, jsched, use_kernel=False)
    with torch.no_grad():
        got = p_tiled.render_tiled(pplan, ps, sched)
    planes_close(got, ref)


def test_sparse_frame_equals_dense_frame():
    """At threshold 0 the dropped bricks have zero density, so the sparse
    f32 frame is the dense f32 frame, bit for bit; the bfloat16 sparse
    frame is the bfloat16 dense frame."""
    _, dense, _, pplan, ps = sparse()
    pd = port_field(dense)
    with torch.no_grad():
        for dtype in ("float32", "bfloat16"):
            field_s = (ps if dtype == "float32"
                       else sparse(dtype=dtype)[4])
            field_d = pd.with_packed_dtype(dtype)
            a = p_tiled.render_tiled(pplan, field_s, sparse_schedules(
                dtype)[1])
            b = p_tiled.render_tiled(pplan, field_d,
                                     p_tiled.build_tiled_schedule(
                                         pplan, field_d).to("cpu"))
            for key in ("image", "transmittance", "opacity", "depth"):
                assert torch.equal(getattr(a, key), getattr(b, key)), (
                    dtype, key)
            assert float(a.opacity.max()) > 0.0


def test_render_tiled_checks_table_kind():
    _, dense, _, pplan, ps = sparse()
    sched = sparse_schedules()[1]
    pd = port_field(dense)
    with torch.no_grad(), pytest.raises(P.DvrenError, match="sparse"):
        p_tiled.render_tiled(pplan, pd, sched)
    dense_sched = p_tiled.build_tiled_schedule(pplan, pd).to("cpu")
    with torch.no_grad(), pytest.raises(P.DvrenError, match="dense"):
        p_tiled.render_tiled(pplan, ps, dense_sched)


# ---------------------------------------------------------------- gradients


def test_sparse_grads_match_jax():
    """f32 bricks: autograd of the port's render_tiled against jax.grad of
    the JAX reference render, within 2e-6 x scale."""
    plan, _, js, pplan, ps = sparse()
    jsched, sched = sparse_schedules()

    def loss(bricks):
        return all_heads_jax(j_tiled.render_tiled(
            plan, js.with_params(bricks), jsched, use_kernel=False))

    want = jax.jit(jax.grad(loss))(js.bricks)
    leaf = ps.with_params(ps.bricks.detach().clone())
    got, = torch.autograd.grad(
        all_heads_port(p_tiled.render_tiled(pplan, leaf, sched)),
        (leaf.bricks,))
    assert got.dtype == torch.float32 and got.shape == ps.bricks.shape
    close(got.numpy(), want, GRID_TOL)


@pytest.mark.parametrize("dtype", DTYPES16)
def test_grads16_match_jax(dtype):
    """Dense 16-bit: d(sigma, color) through K5a/K5b's twins against
    jax.grad, within c * ulp x scale."""
    plan, jf, jsched, pplan, pf, sched = dense16(dtype)

    def loss(params):
        return all_heads_jax(j_tiled.render_tiled(
            plan, jf.with_params(*params), jsched, use_kernel=False))

    want = jax.jit(jax.grad(loss))((jf.sigma, jf.color))
    leaf = pf.with_params(pf.sigma.detach().clone(),
                          pf.color.detach().clone())
    got = torch.autograd.grad(
        all_heads_port(p_tiled.render_tiled(pplan, leaf, sched)),
        (leaf.sigma, leaf.color))
    tol = max_class(sched) * ULP16[dtype]
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        close(a.numpy(), b, tol)
        assert float(a.abs().max()) > 0.0


def test_sparse_bf16_grads_match_jax():
    """bfloat16 bricks: d(bricks) in bfloat16 against jax.grad's, within
    c * ulp x scale."""
    plan, _, js, pplan, ps = sparse(dtype="bfloat16")
    jsched, sched = sparse_schedules("bfloat16")

    def loss(bricks):
        return all_heads_jax(j_tiled.render_tiled(
            plan, js.with_params(bricks), jsched, use_kernel=False))

    want = jax.jit(jax.grad(loss))(js.bricks)
    assert want.dtype == jnp.bfloat16
    leaf = ps.with_params(ps.bricks.detach().clone())
    got, = torch.autograd.grad(
        all_heads_port(p_tiled.render_tiled(pplan, leaf, sched)),
        (leaf.bricks,))
    assert got.dtype == torch.bfloat16
    close(got.float().numpy(), np.asarray(want, np.float32),
          max_class(sched) * ULP16["bfloat16"])


@pytest.mark.parametrize("dtype", DTYPES16)
def test_table16_reduction_single_slot_cells_equal(dtype):
    """The same f32 slot rows through both reductions: JAX's transpose of
    take(table16, hostmap).astype(float32) (a scatter-add in the 16-bit
    type) and the port's slot_rows_to_table_as (f32 sums rounded once).
    Cells with one slot are equal; the rest within c * ulp x scale."""
    jsched, sched = sparse_schedules(dtype="bfloat16")
    hostmap = sched.hostmap_all.numpy()
    n_rows = int(sched.gather_plan.inv_map.shape[0])
    rows = np.random.default_rng(9).normal(
        size=(hostmap.size, 32)).astype(np.float32)
    rows[hostmap < 0] = 0.0          # dead lanes: K2 writes zeros there
    jdt = j_grid.table_dtype(dtype)
    table = jnp.zeros((n_rows, 32), jdt)
    _, vjp = jax.vjp(
        lambda t: jnp.take(t, jnp.asarray(hostmap), axis=0).astype(
            jnp.float32), table)
    want = np.asarray(vjp(jnp.asarray(rows))[0], np.float32)
    got = p_tiled.slot_rows_to_table_as(
        torch.from_numpy(rows), sched.gather_plan, n_rows,
        getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    single = np.zeros(n_rows, bool)
    plan = sched.gather_plan
    for off, n_k, c_k in plan.meta:
        if c_k == 1:
            single[hostmap[plan.all_idx[off:off + n_k].numpy()]] = True
    assert single.sum() > 100 and (~single).sum() > 100
    np.testing.assert_array_equal(got[single], want[single])
    close(got, want, max_class(sched) * ULP16[dtype])


# ---------------------------------------------------------------- Renderer


def port_renderer(pplan):
    return P.Renderer(P.Context.create(device="cpu"), pplan,
                      P.RenderOptions(use_tiles=True))


def test_renderer_sparse_forward_backward():
    """As tests/test_sparse_grid.py::test_renderer_tiled_sparse_forward_
    backward: the frame against the dense pipeline render, d(bricks)
    against jax.grad of that referee within rtol 1e-4 / atol 1e-6; sigma
    and color empty; repeat backwards equal."""
    plan, dense, js, pplan, ps = sparse()
    r = port_renderer(pplan)
    fr = r.forward(ps)
    assert "tiled_path" in fr.stats.notes
    full = render(plan, dense).planes
    np.testing.assert_allclose(
        fr.image.reshape(plan.height, plan.width, 3),
        np.asarray(full.image), atol=1e-5)
    dl = np.ones(plan.ray_count * 3, np.float32)
    br = r.backward(ps, dl)
    assert br.bricks.shape == tuple(ps.bricks.shape)
    assert br.bricks.dtype == np.float32
    assert br.sigma.size == 0 and br.color.size == 0
    assert br.camera.shape == (3, 4) and br.camera_k.shape == (3, 3)

    def loss(bricks):
        return jnp.sum(render(plan, js.with_params(bricks)).planes.image)

    want = jax.grad(loss)(js.bricks)
    np.testing.assert_allclose(br.bricks, np.asarray(want), rtol=1e-4,
                               atol=1e-6)
    again = r.backward(ps, dl)
    np.testing.assert_array_equal(again.bricks, br.bricks)


def test_renderer_backward16_equals_autograd():
    """Renderer.backward on a bfloat16 dense field: d(sigma, color) are
    autograd's of render_tiled (the same K5b route), and the stats note
    counts K5a (0 launches on the CPU)."""
    _, _, _, pplan, pf, sched = dense16("bfloat16")
    r = port_renderer(pplan)
    fr = r.forward(pf)
    assert "kernel_launches=packed_table16:0" in fr.stats.notes
    dl = np.random.default_rng(2).uniform(
        -1, 1, (pplan.ray_count, 3)).astype(np.float32)
    br = r.backward(pf, dl)
    leaf = pf.with_params(pf.sigma.detach().clone(),
                          pf.color.detach().clone())
    img = p_tiled.render_tiled(pplan, leaf, sched).image
    want = torch.autograd.grad(
        torch.sum(img * torch.from_numpy(dl.reshape(img.shape))),
        (leaf.sigma, leaf.color))
    np.testing.assert_array_equal(br.sigma, want[0].numpy().reshape(-1))
    np.testing.assert_array_equal(br.color, want[1].numpy().reshape(-1))
    assert br.bricks is None


def test_renderer_keys_sparse_schedule_by_occupancy():
    """Two sparse fields of one shape, bbox and brick count whose
    occupancy differs (two slots swapped): the Renderer rebuilds, and
    renders the second exactly as a fresh Renderer does. (dvren_tpu's key
    ignores the occupancy and would replay the first schedule.)"""
    _, _, _, pplan, ps = sparse()
    occ = ps.occupancy.clone()
    flat = occ.reshape(-1)
    a, b = torch.nonzero(flat).reshape(-1)[:2]
    flat[a], flat[b] = flat[b].clone(), flat[a].clone()
    swapped = P.SparseGridField(ps.bricks.detach(), occ, ps.grid_shape,
                                bbox_min=ps.bbox_min, bbox_max=ps.bbox_max)
    r = port_renderer(pplan)
    first = r.forward(ps)
    second = r.forward(swapped)
    assert any(n.startswith("tiled_schedule_build_ms=")
               for n in second.stats.notes)
    fresh = port_renderer(pplan).forward(swapped)
    np.testing.assert_array_equal(second.image, fresh.image)
    assert not np.array_equal(second.image, first.image)
    third = r.forward(ps)
    np.testing.assert_array_equal(third.image, first.image)


# ----------------------------------------------------------------- repairs


def _constructors():
    plan, field = scene()
    sigma, color = np.asarray(field.sigma), np.asarray(field.color)
    cfg = P.DenseGridConfig(resolution=(8, 8, 8), sigma=sigma.reshape(-1),
                            color=color.reshape(-1))
    spec = P.HashMLPSpec()
    flat = np.zeros(spec.param_count, np.float32)
    hash_params = {k: v.detach().numpy() for k, v in P.HashMLPField.create(
        P.HashMLPConfig(spec=spec), device="cpu").params.items()}
    dense = port_field(field)
    js = JSparse.from_dense(field)
    return {
        "dense_create": lambda **kw: P.DenseGridField.create(cfg, **kw),
        "dense_from_reference_arrays":
            lambda **kw: P.DenseGridField.from_reference_arrays(
                sigma, color, field.bbox_min, field.bbox_max, **kw),
        "hash_create": lambda **kw: P.HashMLPField.create(
            P.HashMLPConfig(spec=spec, params=flat), **kw),
        "hash_init_random": lambda **kw: P.HashMLPField.init_random(
            torch.Generator().manual_seed(0), spec=spec, **kw),
        "hash_from_reference_params":
            lambda **kw: P.HashMLPField.from_reference_params(
                hash_params, spec, **kw),
        "sparse_from_dense":
            lambda **kw: P.SparseGridField.from_dense(dense, **kw),
        "sparse_from_reference":
            lambda **kw: P.SparseGridField.from_reference(
                np.asarray(js.bricks), np.asarray(js.occupancy),
                js.grid_shape, js.bbox_min, js.bbox_max, **kw),
    }


@pytest.mark.parametrize("name", ["dense_create",
                                  "dense_from_reference_arrays",
                                  "hash_create", "hash_init_random",
                                  "hash_from_reference_params",
                                  "sparse_from_dense",
                                  "sparse_from_reference"])
def test_constructor_without_device_needs_cuda(name, monkeypatch):
    """No device named means CUDA, as for Context: where torch has no
    CUDA the constructor raises DvrenError naming device='cpu', and never
    builds the field on the CPU."""
    make = _constructors()[name]
    field = make(device="cpu")
    assert field.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(P.DvrenError, match="device='cpu'"):
        make()
