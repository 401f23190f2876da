"""The tiled backward of dvren_tpu_torch against dvren_tpu, on the CPU.

Same inputs (tests/test_tiled.py::scene, weights carried across as numpy)
through both packages. The JAX side runs as its own suite runs it on the
CPU: Pallas kernels in interpret mode, or the pure-jnp reference
consumer (``use_kernel=False``) where the kernel path is not needed.
Tolerances are the JAX package's for its own kernel
(tests/test_fused_tiles.py): grids 2e-6 x scale, camera rtol 2e-3 /
atol 1e-4; the gather plan is equal array for array, the table-gradient
unpack value for value, and repeat runs bit for bit. On the CPU every
kernel wrapper runs its plain twin; tests/test_torch_cuda.py holds the
CUDA kernels to the twins on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.ops import fused_tiles as j_ft
from dvren_tpu.ops import grid as j_grid
from dvren_tpu.ops import packed_transpose as j_pt
from dvren_tpu.ops import raygen as j_raygen
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests.test_tiled import scene
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import fused_tiles as p_ft
from dvren_tpu_torch.ops import gather_plan as p_gp
from dvren_tpu_torch.ops import packed_transpose as p_pt
from dvren_tpu_torch.ops import raygen as p_raygen
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

GRID_TOL = 2e-6       # x max |reference|
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4
SCENES = {
    "fixed": {},
    "stratified": dict(mode=J.SamplingMode.STRATIFIED),
    "roi": dict(width=50, height=38,
                roi=J.Roi(x=3, y=5, width=41, height=27)),
    "opaque": dict(mode=J.SamplingMode.STRATIFIED),
}


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX plan, JAX field, JAX numpy schedule, port plan, port CPU
    schedule) for one scene; "opaque" is dense enough that rays stop
    early, "zeros" has exact-zero sigma over more than half the grid."""
    if name == "zeros":
        plan, field = scene(mode=J.SamplingMode.STRATIFIED)
        sigma = np.array(field.sigma)
        sigma[:, :, : sigma.shape[2] // 3] = 0.0
        sigma[: sigma.shape[0] // 2] = 0.0
        field = field.with_params(jnp.asarray(sigma), field.color)
    else:
        plan, field = scene(**SCENES[name])
        if name == "opaque":
            field = field.with_params(field.sigma * 25.0, field.color)
    ref = j_tiled.build_tiled_schedule(
        plan, field, jitter=plan_jitter_table(plan), device=False)
    pplan = port_plan(plan)
    got = p_tiled.build_tiled_schedule(pplan, port_field(field))
    return plan, field, ref, pplan, got.to("cpu")


def close(got, ref, tol=GRID_TOL):
    """|got - ref| <= tol * max |ref|."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale)


def all_heads_jax(pls):
    """The all-heads loss of tests/test_fused_tiles.py:97-103."""
    return (jnp.mean(pls.image ** 2) + 0.1 * jnp.mean(pls.opacity)
            + 0.01 * jnp.mean(pls.depth)
            + 0.01 * jnp.mean(pls.transmittance))


def all_heads_port(pls):
    return (torch.mean(pls.image ** 2) + 0.1 * torch.mean(pls.opacity)
            + 0.01 * torch.mean(pls.depth)
            + 0.01 * torch.mean(pls.transmittance))


def jax_grid_grads(name, loss_of_planes=all_heads_jax):
    """jax.grad of a loss of the JAX reference render in (sigma, color)."""
    plan, field, ref, _, _ = case(name)
    sched = j_tiled.build_tiled_schedule(plan, field,
                                         jitter=plan_jitter_table(plan))

    def loss(params):
        return loss_of_planes(j_tiled.render_tiled(
            plan, field.with_params(*params), sched, use_kernel=False))

    return jax.jit(jax.grad(loss))((field.sigma, field.color))


def port_grid_grads(name, loss_of_planes=all_heads_port):
    _, field, _, pplan, sched = case(name)
    pfield = port_field(field)
    loss = loss_of_planes(p_tiled.render_tiled(pplan, pfield, sched))
    return torch.autograd.grad(loss, (pfield.sigma, pfield.color))


# ------------------------------------------------------------ gather plan


@pytest.mark.parametrize("name", ["fixed", "stratified", "roi"])
def test_gather_plan_equal(name):
    _, _, ref, _, got = case(name)
    gr, gp = ref.gather_plan, got.gather_plan
    assert gp is not None and gp.meta == tuple(gr.meta)
    for key in ("all_idx", "inv_map"):
        a, b = np.asarray(getattr(gr, key)), getattr(gp, key).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)


def test_gather_plan_empty():
    assert p_gp.build_gather_plan(np.zeros(0, np.int32), 8) is None
    assert p_gp.build_gather_plan(np.full(4, -1, np.int32), 8) is None


@pytest.mark.parametrize("name", ["stratified", "roi"])
def test_slot_reduction_matches_reference(name):
    """The f32 slot-row reduction against the JAX package's u16 one."""
    _, _, ref, _, got = case(name)
    rows = np.random.default_rng(1).normal(
        size=(ref.hostmap_all.size, 32)).astype(np.float32)
    n_cells = int(ref.gather_plan.inv_map.shape[0])
    want = j_tiled.ct16_rows_to_table(
        j_grid._split_u16(jnp.asarray(rows)), ref.gather_plan.all_idx,
        ref.gather_plan.meta, ref.gather_plan.inv_map, 32)
    out = p_gp.slot_rows_to_table(torch.from_numpy(rows),
                                  got.gather_plan, n_cells)
    assert out.shape == (n_cells, 32)
    close(out.numpy(), want, tol=1e-6)


# ---------------------------------------------------------------- raygen


def _camera_scene(model):
    if model == "ortho":
        return J.Plan.create(J.PlanConfig(
            width=20, height=12, t_near=0.1, t_far=2.6, seed=4,
            camera=J.CameraConfig(
                model=J.CameraModel.ORTHOGRAPHIC, ortho_scale=0.02,
                k=(1.0, 0, 10.0, 0, 1.0, 6.0, 0, 0, 1),
                c2w=(0.96, -0.28, 0, 0.5, 0.28, 0.96, 0, 0.5, 0, 0, 1,
                     -1.0))))
    plan, _ = scene(width=50, height=38,
                    roi=J.Roi(x=3, y=5, width=41, height=27))
    return plan


@pytest.mark.parametrize("model", ["pinhole", "ortho", "ids"])
def test_generate_rays_and_camera_grads(model):
    plan = _camera_scene("ortho" if model == "ortho" else "pinhole")
    pplan = port_plan(plan)
    ids = (np.random.default_rng(5).integers(0, plan.ray_count + 40, 300)
           .astype(np.int32) if model == "ids" else None)
    k0 = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
    c2w0 = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
    n = plan.ray_count if ids is None else ids.size
    rng = np.random.default_rng(6)
    wo, wd = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))

    def jax_loss(k, c2w, scale):
        r = j_raygen.generate_rays(plan, k=k, c2w=c2w, ortho_scale=scale,
                                   ids=None if ids is None
                                   else jnp.asarray(ids))
        return jnp.sum(r.origins * wo) + jnp.sum(r.directions * wd)

    scale0 = np.float32(plan.camera.ortho_scale)
    ref = j_raygen.generate_rays(plan, ids=None if ids is None
                                 else jnp.asarray(ids))
    g_ref = jax.grad(jax_loss, argnums=(0, 1, 2))(k0, c2w0, scale0)

    k, c2w, scale = (torch.tensor(a, requires_grad=True)
                     for a in (k0, c2w0, scale0))
    got = p_raygen.generate_rays(
        pplan, k=k, c2w=c2w, ortho_scale=scale,
        ids=None if ids is None else torch.from_numpy(ids))
    for key in ("origins", "directions", "t_near", "t_far"):
        np.testing.assert_allclose(getattr(got, key).detach().numpy(),
                                   np.asarray(getattr(ref, key)), atol=1e-6,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(got.pixel_ids.numpy(),
                                  np.asarray(ref.pixel_ids))
    loss = (torch.sum(got.origins * torch.from_numpy(wo))
            + torch.sum(got.directions * torch.from_numpy(wd)))
    grads = torch.autograd.grad(loss, (k, c2w, scale), allow_unused=True)
    for a, b in zip(grads, g_ref):
        a = np.zeros_like(np.asarray(b)) if a is None else a.numpy()
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- K2 twin


@pytest.mark.parametrize("name", ["stratified", "roi", "opaque"])
def test_k2_plain_matches_reference(name):
    plan, field, ref, pplan, got = case(name)
    geom = (ref.bbox[0], ref.bbox[1], ref.grid_shape)
    shapes = [(g.n_tiles, g.banks) for g in ref.groups]
    tabs_ref = j_tiled._t16_to_banks(
        j_grid.build_packed_table16(field.sigma, field.color),
        ref.gathermap_all, (1, tuple(shapes)))
    pfield = port_field(field)
    tabs = p_tiled._gather_bank_tables(
        p_pt.build_rows_plain(pfield.sigma.detach(), pfield.color.detach()),
        got.gathermap_all, shapes)
    rng = np.random.default_rng(11)
    for gi, (gr, gp) in enumerate(zip(ref.groups, got.groups)):
        gs = rng.normal(size=(gr.n_tiles, 5, 16, 16)).astype(np.float32)
        kp = j_ft.tile_op_params(plan, geom, gr.banks, gr.n_chunks, 1,
                                 gr.n_tiles, cam_grads=True)
        d_tabs, d_cam = jax.jit(functools.partial(
            j_ft._tile_op(*kp).bwd_call, emit="banks"))(
            tabs_ref[gi], gr.samp, gr.base, gr.rayt,
            gr.k_enter.reshape(-1).astype(np.int32),
            gr.bank0.reshape(-1).astype(np.int32), gs)
        args = (tabs[gi], gp.samp, gp.base, gp.rayt, gp.k_enter,
                gp.bank0.reshape(-1), torch.from_numpy(gs),
                p_ft.tile_op_params(pplan, geom, gp.banks, gp.n_chunks))
        rows, d_rayt = p_ft.tile_backward_plain(*args, cam=True)
        assert rows.shape == (gr.n_tiles, gr.banks, 128, 32)
        close(rows.numpy(), np.swapaxes(np.asarray(d_tabs), 2, 3))
        close(d_rayt.numpy(), np.asarray(d_cam).reshape(gr.n_tiles, 12, 128),
              tol=1e-5)
        rows_nc, none = p_ft.tile_backward_plain(*args, cam=False)
        assert none is None and torch.equal(rows_nc, rows)


def test_k2_wrapper_takes_plain_twin_on_cpu():
    """The first group as a one-shape set: the wrapper runs K2's twin on
    the CPU, no launch counted; a bad cotangent is refused."""
    _, field, _, pplan, got = case("fixed")
    geom = (got.bbox[0], got.bbox[1], got.grid_shape)
    sched = got.to("cpu")
    g = sched.groups[0]
    pfield = port_field(field)
    tiles = p_ft.tile_set([g], 1)
    tabs = p_tiled._gather_banks_flat(
        p_pt.build_rows_plain(pfield.sigma.detach(), pfield.color.detach()),
        g.gathermap)
    gs = torch.ones((g.n_tiles, 5, 16, 16))
    prm = p_ft.tiles_op_params(pplan, geom, tiles)
    before = p_ft.tile_backward.launches
    rows, d_rayt = p_ft.tile_backward(tabs, tiles, gs, prm, cam=True)
    assert p_ft.tile_backward.launches == before
    want = p_ft.tile_backward_plain(
        tabs.reshape(g.n_tiles, g.banks, 32, 128), g.samp, g.base, g.rayt,
        g.k_enter, g.bank0.reshape(-1), gs, prm, cam=True)
    assert torch.equal(rows, want[0].reshape(-1, 128, 32))
    assert torch.equal(d_rayt, want[1])
    with pytest.raises(ValueError):
        p_ft.tile_backward(tabs, tiles, gs[:, :4], prm)
    with pytest.raises(TypeError):
        p_ft.tile_backward(tabs, tiles, gs.double(), prm)


def test_tie_gradient_is_half():
    x = torch.tensor([-1.0, -0.0, 0.0, 2.0])
    assert p_ft._tie(x).tolist() == [0.0, 0.5, 0.5, 1.0]


# --------------------------------------------------------------- K4 twin


@pytest.mark.parametrize("shape", [(8, 8, 8), (5, 7, 9), (3, 17, 40),
                                   (2, 2, 2)])
def test_k4_plain_matches_reference(shape):
    """Value for value: the twin sums its shifted planes from 0 in
    corner order, as the JAX function's ``sum`` does."""
    rows = j_grid.fullpitch_rows(shape)
    x = np.random.default_rng(3).normal(size=(rows, 32)).astype(np.float32)
    want = j_grid.stack_plane_grads(
        j_pt.u16_rows_to_stack(j_grid._split_u16(jnp.asarray(x))), shape)
    got = p_pt.table_grad_to_params_plain(torch.from_numpy(x), shape)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    before = p_pt.table_grad_to_params.launches
    again = p_pt.table_grad_to_params(torch.from_numpy(x), shape)
    assert p_pt.table_grad_to_params.launches == before
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_k4_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        p_pt.table_grad_to_params(torch.zeros((100, 32)), (4, 4, 4))
    with pytest.raises(TypeError):
        p_pt.table_grad_to_params(torch.zeros((2048, 32),
                                              dtype=torch.float64),
                                  (4, 4, 4))


# ----------------------------------------------------- through render_tiled


@pytest.mark.parametrize("name", ["stratified", "roi"])
def test_render_tiled_grads_all_heads(name):
    """Autograd of the port's render_tiled against jax.grad of the JAX
    reference render, through radiance, opacity, depth and
    transmittance."""
    for a, b in zip(port_grid_grads(name), jax_grid_grads(name)):
        close(a.numpy(), b)


def test_zero_sigma_tie_gradient():
    """Exact-zero sigma cells put samples at max(x, 0)'s kink x == 0,
    where JAX's gradient is 0.5: the port's d_sigma must equal JAX's
    there, and fails if the tie is lost. The radiance head only: at such
    cells the JAX reference's transmittance (a min over tied prefixes)
    and its kernel's (exp of the processed sum) differ in gradient."""
    dl = np.random.default_rng(8).uniform(-1, 1, (32, 48, 3)).astype(
        np.float32)
    g_ref = jax_grid_grads("zeros", lambda pls: jnp.sum(pls.image * dl))
    g_got = port_grid_grads(
        "zeros", lambda pls: torch.sum(pls.image * torch.from_numpy(dl)))
    for a, b in zip(g_got, g_ref):
        close(a.numpy(), b)
    zero = np.asarray(case("zeros")[1].sigma) == 0.0
    assert np.abs(g_got[0].numpy()[zero]).max() > 0.0


def test_backward_graph_has_no_accumulating_scatter():
    """No node of the backward graph is a traced gather or scatter (their
    backwards add with float atomics on CUDA)."""
    _, field, _, pplan, sched = case("roi")
    pfield = port_field(field)
    k = torch.tensor(pplan.camera.k).reshape(3, 3).requires_grad_(True)
    loss = all_heads_port(p_tiled.render_tiled(pplan, pfield, sched, k=k))
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(f for f, _ in node.next_functions)
    names = {type(n).__name__ for n in seen}
    assert "_GroupsetFromParamsBackward" in names
    bad = {n for n in names if n.startswith(("Index", "Gather", "Scatter",
                                             "Put", "MaskedSelect"))}
    assert not bad, bad


def _camera_loss_jax(name):
    plan, field, _, _, _ = case(name)
    sched = j_tiled.build_tiled_schedule(plan, field,
                                         jitter=plan_jitter_table(plan))
    dl = np.random.default_rng(7).uniform(
        -1, 1, (plan.height, plan.width, 3)).astype(np.float32)

    def loss(c2w, k):
        img = j_tiled.render_tiled(plan, field, sched, k=k, c2w=c2w).image
        return jnp.sum(img * dl)

    return loss, dl


def test_camera_grads_match_reference_and_fd():
    name = "fixed"
    plan, field, _, pplan, sched = case(name)
    jloss, dl = _camera_loss_jax(name)
    k0 = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
    c2w0 = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
    g_c2w, g_k = jax.jit(jax.grad(jloss, argnums=(0, 1)))(c2w0, k0)

    pfield = port_field(field)
    dl_t = torch.from_numpy(dl)

    def loss(c2w, k):
        img = p_tiled.render_tiled(pplan, pfield, sched, k=k, c2w=c2w).image
        return torch.sum(img * dl_t)

    c2w, k = (torch.tensor(a, requires_grad=True) for a in (c2w0, k0))
    got_c2w, got_k = torch.autograd.grad(loss(c2w, k), (c2w, k))
    assert got_c2w.abs().sum() > 0
    np.testing.assert_allclose(got_c2w.numpy(), np.asarray(g_c2w),
                               rtol=CAM_RTOL, atol=CAM_ATOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(g_k),
                               rtol=CAM_RTOL, atol=CAM_ATOL)

    # central differences of the same fixed-schedule loss
    rel = lambda a, b: abs(a - b) / max(abs(a), abs(b), 1e-6)
    eps = 1e-3
    with torch.no_grad():
        for idx in (3, 7, 11, 0, 5):
            e = torch.zeros(12)
            e[idx] = eps
            e = e.reshape(3, 4)
            fd = (float(loss(c2w + e, k)) - float(loss(c2w - e, k))) / (2 * eps)
            assert rel(float(got_c2w.reshape(-1)[idx]), fd) < 2e-2, idx


# --------------------------------------------------------------- Renderer


@functools.lru_cache(maxsize=None)
def _renderers(name):
    plan, field, _, pplan, _ = case(name)
    jr = J.Renderer(J.Context.create(), plan,
                    J.RenderOptions(use_tiles=True, capture_stats=False))
    jr.forward(field)
    pr = P.Renderer(P.Context.create(device="cpu"), pplan,
                    P.RenderOptions(use_tiles=True))
    pfield = port_field(field)
    pr.forward(pfield)
    return jr, pr, pfield


def test_renderer_backward_matches_reference():
    name = "stratified"
    plan, field, _, _, _ = case(name)
    jr, pr, pfield = _renderers(name)
    dl = np.random.default_rng(3).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    want = jr.backward(field, dl)
    got = pr.backward(pfield, dl)
    assert isinstance(got, P.BackwardResult)
    for key in ("sigma", "color"):
        assert getattr(got, key).shape == getattr(want, key).shape
        close(getattr(got, key), getattr(want, key))
    assert got.camera.shape == (3, 4) and got.camera_k.shape == (3, 3)
    np.testing.assert_allclose(got.camera, want.camera, rtol=CAM_RTOL,
                               atol=CAM_ATOL)
    np.testing.assert_allclose(got.camera_k, want.camera_k, rtol=CAM_RTOL,
                               atol=CAM_ATOL)
    assert got.sample_count == want.sample_count
    # repeat runs are bit-identical
    again = pr.backward(pfield, dl.reshape(-1, 3))
    for key in ("sigma", "color", "camera", "camera_k"):
        np.testing.assert_array_equal(getattr(again, key), getattr(got, key))


def test_renderer_backward_errors():
    """As tests/test_backward_fd.py:253-266: no prior forward, wrong
    dL/dI size."""
    plan, field, _, pplan, _ = case("fixed")
    pfield = port_field(field)
    r = P.Renderer(P.Context.create(device="cpu"), pplan,
                   P.RenderOptions(use_tiles=True))
    with pytest.raises(P.DvrenError):
        r.backward(pfield, np.zeros(plan.ray_count * 3, np.float32))
    r.forward(pfield)
    with pytest.raises(P.DvrenError):
        r.backward(pfield, np.zeros(7, np.float32))
    with pytest.raises(P.DvrenError):
        r.backward(object(), np.zeros(plan.ray_count * 3, np.float32))


# --------------------------------------------------------------- training


def test_sgd_steps_match_reference():
    """bench.py's training loop, 4 steps: MSE against a zero target, SGD
    at lr 1e-3 on (sigma, color). The JAX side runs its reference render
    (use_kernel=False) under jax.lax.scan."""
    name, steps, lr = "stratified", 4, 1e-3
    plan, field, _, pplan, sched = case(name)
    jsched = j_tiled.build_tiled_schedule(plan, field,
                                          jitter=plan_jitter_table(plan))
    target = jnp.zeros((plan.height, plan.width, 3), jnp.float32)

    def loss_tiled(p):
        img = j_tiled.render_tiled(plan, field.with_params(*p), jsched,
                                   use_kernel=False).image
        return jnp.mean((img - target) ** 2)

    def body(p, _):
        val, g = jax.value_and_grad(loss_tiled)(p)
        return (p[0] - lr * g[0], p[1] - lr * g[1]), val

    p_ref, loss_ref = jax.jit(lambda p: jax.lax.scan(
        body, p, None, length=steps))((field.sigma, field.color))

    pfield = port_field(field)
    opt = torch.optim.SGD(pfield.parameters(), lr=lr)
    target_t = torch.zeros((plan.height, plan.width, 3))
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = p_fit.mse(p_tiled.render_tiled(pplan, pfield, sched).image,
                         target_t)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, np.asarray(loss_ref), rtol=1e-6)
    assert losses[-1] < losses[0]
    for got, init, want in ((pfield.sigma, field.sigma, p_ref[0]),
                            (pfield.color, field.color, p_ref[1])):
        close(got.detach().numpy() - np.asarray(init),
              np.asarray(want) - np.asarray(init))
    assert float(p_fit.psnr(torch.tensor(losses[-1]))) == pytest.approx(
        float(-10.0 * np.log10(losses[-1])), rel=1e-6)
