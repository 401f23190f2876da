"""The split tiled backward of dvren_tpu_torch against dvren_tpu, on the
CPU: K6 (``packed_transpose.banks_to_rows``), K2's bank-block form and the
``BWD_SPLIT`` route.

Same seeded inputs through both packages, on tests/test_tiled.py::scene
(48x32 rays over 8^3). The JAX side runs as its own suite runs it on the
CPU: Pallas in interpret mode (``banks_to_u16_rows``, ``bwd_call(emit=
"banks")``, ``_cts_to_ct16`` under ``BWD_SPLIT="pallas"``), and the
reference consumer (``use_kernel=False``) under ``jax.grad``. Held:

- K6's twin equal to ``banks_to_u16_rows`` recombined (hi << 16 | lo),
  bit for bit, -0.0, subnormals, infinities and NaN payloads included;
- K2's bank-form twin within 2e-6 x scale of JAX's ``emit="banks"``, and
  equal to its own rows form transposed, bit for bit, at subs 1, 4, 16;
- the relayed slot rows of every group equal to JAX's ``_cts_to_ct16``
  recombined, bit for bit, with every group's block count a multiple of 8
  (so that JAX's side ran its kernel, not its fallback);
- under ``BWD_SPLIT = "pallas"``: the gradients of ``render_tiled`` on a
  sparse float32 field, of ``render_tiled_stack`` on a two-view dense
  merge and of ``Renderer.backward`` on a sparse field equal the "xla"
  route's bit for bit, with K6 (its twin, on the CPU) called once per
  group, and lie within 2e-6 x scale of ``jax.grad`` of JAX's reference;
  a 3-step ``fit_dense_grid(mode="tiled")`` equal to the "xla" route's
  bit for bit, and within tests/test_torch_fit.py's fit bounds (losses
  rtol 1e-4, fields 1e-4) of an optax loop over JAX's reference stack;
- the routes that JAX keeps off the flag (single-view dense float32,
  supercell, 16-bit tables) make no K6 call;
- the flag's environment variable, read at import, and the ValueError of
  an unknown value at the first backward of a route that reads it.

tests/test_torch_cuda.py holds K6 and K2's bank form to their twins on the
card.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse
from dvren_tpu.ops import fused_tiles as j_ft
from dvren_tpu.ops import grid as j_grid
from dvren_tpu.ops import packed_transpose as j_pt
from dvren_tpu.opt import fit as j_fit
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from tests.test_tiled import scene
from tests.test_torch_backward import case
from tests.test_torch_core import port_field, port_plan

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import fused_tiles as p_ft
from dvren_tpu_torch.ops import packed_transpose as p_pt
from dvren_tpu_torch.ops.grid import build_supercell_stencil
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

GRID_TOL = 2e-6       # x max |reference|
LOSS_RTOL = 1e-4      # tests/test_torch_fit.py's fit bounds
FIELD_TOL = 1e-4
FIT_STEPS = 3
# tests/test_tiled.py:479-480
VIEW_C2WS = tuple((1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0, 1, -1.0)
                  for dx in (0.0, 0.1))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# -0.0, subnormals, +-inf, NaNs with payloads (quiet and signalling)
SPECIALS = np.array([0x80000000, 0x00000001, 0x807FFFFF, 0x00400000,
                     0x7F800000, 0xFF800000, 0x7FC00001, 0xFFC12345,
                     0x7F800001, 0xFFA00000], np.uint32)


def close(got, ref, tol=GRID_TOL):
    """|got - ref| <= tol * max |ref|."""
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * scale)


def recombine(rows16) -> np.ndarray:
    """JAX's (S, 64) u16 split rows -> (S, 32) int32 words hi << 16 | lo."""
    r = np.asarray(rows16).astype(np.uint32)
    return ((r[:, :32] << 16) | r[:, 32:]).view(np.int32)


def words(rows: torch.Tensor) -> np.ndarray:
    return rows.view(torch.int32).numpy()


def special_banks(n_blocks: int, seed: int) -> np.ndarray:
    """Seeded (B, 32, 128) f32 blocks of normal values with SPECIALS at
    random places in every block."""
    rng = np.random.default_rng(seed)
    banks = rng.normal(size=(n_blocks, 32, 128)).astype(np.float32)
    bits = banks.view(np.uint32).reshape(n_blocks, -1)
    for b in range(n_blocks):
        cols = rng.choice(32 * 128, size=SPECIALS.size, replace=False)
        bits[b, cols] = SPECIALS
    return banks


@pytest.fixture
def k6_spy(monkeypatch):
    """Counts the calls of K6's twin (what its wrapper runs on the CPU)."""
    calls = []
    plain = p_pt.banks_to_rows_plain

    def spy(banks):
        calls.append(int(banks.shape[0]))
        return plain(banks)

    monkeypatch.setattr(p_pt, "banks_to_rows_plain", spy)
    return calls


def set_split(monkeypatch, value):
    monkeypatch.setattr(p_tiled, "BWD_SPLIT", value)


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize("n_blocks", [8, 24])
def test_k6_twin_matches_jax(n_blocks):
    banks = special_banks(n_blocks, seed=n_blocks)
    want = recombine(j_pt.banks_to_u16_rows(jnp.asarray(banks), True))
    got = p_pt.banks_to_rows_plain(torch.from_numpy(banks))
    assert got.shape == (n_blocks * 128, 32) and got.is_contiguous()
    np.testing.assert_array_equal(words(got), want)


def test_k6_wrapper_takes_twin_on_cpu():
    banks = torch.from_numpy(special_banks(3, seed=1))
    before = p_pt.banks_to_rows.launches
    rows = p_pt.banks_to_rows(banks)
    assert p_pt.banks_to_rows.launches == before
    np.testing.assert_array_equal(
        words(rows), words(p_pt.banks_to_rows_plain(banks)))
    with pytest.raises(ValueError):
        p_pt.banks_to_rows(banks[:, :, :64].contiguous())
    with pytest.raises(TypeError):
        p_pt.banks_to_rows(banks.double())
    with pytest.raises(ValueError):
        p_pt.banks_to_rows(torch.zeros(3, 128, 32).transpose(1, 2))


# ------------------------------------------------------- K2's bank form


@functools.lru_cache(maxsize=None)
def jax_banks(name):
    """Per group: (seeded cotangent, JAX's K2 emit="banks" in interpret
    mode) on ``case(name)``'s schedule."""
    plan, field, ref, _, _ = case(name)
    geom = (ref.bbox[0], ref.bbox[1], ref.grid_shape)
    shapes = [(g.n_tiles, g.banks) for g in ref.groups]
    tabs = j_tiled._t16_to_banks(
        j_grid.build_packed_table16(field.sigma, field.color),
        ref.gathermap_all, (1, tuple(shapes)))
    rng = np.random.default_rng(21)
    out = []
    for gi, g in enumerate(ref.groups):
        gs = rng.normal(size=(g.n_tiles, 5, 16, 16)).astype(np.float32)
        kp = j_ft.tile_op_params(plan, geom, g.banks, g.n_chunks, 1,
                                 g.n_tiles)
        d_tabs = jax.jit(functools.partial(
            j_ft._tile_op(*kp).bwd_call, emit="banks"))(
            tabs[gi], g.samp, g.base, g.rayt,
            g.k_enter.reshape(-1).astype(np.int32),
            g.bank0.reshape(-1).astype(np.int32), gs)
        out.append((gs, np.asarray(d_tabs)))
    return out


def port_group_args(name):
    """Per group, K2's inputs (but the cotangent) on the port's side."""
    _, field, _, pplan, got = case(name)
    geom = (got.bbox[0], got.bbox[1], got.grid_shape)
    pfield = port_field(field)
    tabs = p_tiled._gather_bank_tables(
        p_pt.build_rows_plain(pfield.sigma.detach(), pfield.color.detach()),
        got.gathermap_all, [(g.n_tiles, g.banks) for g in got.groups])
    return [(tabs[gi], g.samp, g.base, g.rayt, g.k_enter,
             g.bank0.reshape(-1),
             p_ft.tile_op_params(pplan, geom, g.banks, g.n_chunks))
            for gi, g in enumerate(got.groups)]


@pytest.mark.parametrize("name", ["stratified", "roi"])
def test_k2_bank_twin_matches_jax(name):
    for a, (gs, want) in zip(port_group_args(name), jax_banks(name)):
        d_banks, none = p_ft.tile_backward_plain(
            *a[:6], torch.from_numpy(gs), a[6], emit="banks")
        assert none is None
        assert d_banks.shape == want.shape == (a[0].shape[0], a[6].banks,
                                               32, 128)
        close(d_banks.numpy(), want)


def subtile_schedule(tile_px):
    """The stratified test scene at ``tile_px`` cells: (port plan, port
    field, CPU schedule)."""
    plan, field = scene(mode=J.SamplingMode.STRATIFIED)
    pplan, pfield = port_plan(plan), port_field(field)
    sched = p_tiled.build_tiled_schedule(pplan, pfield, tile_px=tile_px)
    return pplan, pfield, sched.to("cpu")


@pytest.mark.parametrize("cam", [False, True])
@pytest.mark.parametrize("tile_px", [16, 8, 4])
def test_k2_banks_equal_rows_transposed(tile_px, cam):
    pplan, pfield, sched = subtile_schedule(tile_px)
    subs = (16 // tile_px) ** 2
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    tabs = p_tiled._gather_bank_tables(
        p_pt.build_rows_plain(pfield.sigma.detach(), pfield.color.detach()),
        sched.gathermap_all, [(g.n_tiles, g.banks) for g in sched.groups])
    gen = torch.Generator().manual_seed(tile_px)
    for gi, g in enumerate(sched.groups):
        tiles = p_ft.tile_set([g], subs)
        args = (tabs[gi].reshape(-1, 32, 128), tiles,
                torch.randn((g.n_tiles, 5, 16, 16), generator=gen),
                p_ft.tiles_op_params(pplan, geom, tiles))
        rows, rayt_r = p_ft.tile_backward(*args, cam=cam)
        banks, rayt_b = p_ft.tile_backward(*args, cam=cam, emit="banks")
        assert banks.shape == (g.n_tiles * g.banks, 32, 128)
        assert torch.equal(banks, rows.transpose(1, 2))
        assert (rayt_r is None) == (not cam)
        assert not cam or torch.equal(rayt_b, rayt_r)


def test_k2_bank_form_cell_stencil_only():
    pplan, pfield, _ = subtile_schedule(16)
    sched = p_tiled.build_tiled_schedule(
        pplan, pfield, tile_px=8, cell_scale=2).to("cpu")
    g = sched.groups[0]
    table = build_supercell_stencil(pfield.sigma.detach(),
                                    pfield.color.detach())
    tabs = p_tiled._gather_banks_flat(table, g.gathermap)
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    tiles = p_ft.tile_set([g], 4)
    prm = p_ft.tiles_op_params(pplan, geom, tiles, "super")
    args = (tabs, tiles, torch.zeros((g.n_tiles, 5, 16, 16)), prm)
    for emit in ("banks", "u16"):
        with pytest.raises(ValueError, match="emit"):
            p_ft.tile_backward(*args, emit=emit)


# ------------------------------------------- the relayed rows against JAX


def test_relayed_rows_match_jax_cts_to_ct16(monkeypatch, k6_spy):
    _, _, ref, _, got = case("stratified")
    rng = np.random.default_rng(5)
    cts = [rng.normal(size=(g.n_tiles, g.banks, 32, 128)).astype(np.float32)
           for g in ref.groups]
    cts[0].reshape(-1).view(np.uint32)[:SPECIALS.size] = SPECIALS
    for g in ref.groups:
        assert (g.n_tiles * g.banks) % 8 == 0
    monkeypatch.setattr(j_tiled, "BWD_SPLIT", "pallas")
    want = recombine(j_tiled._cts_to_ct16(tuple(jnp.asarray(c)
                                                for c in cts)))
    rows = p_tiled._cts_to_rows(torch.from_numpy(np.concatenate(
        [c.reshape(-1, 32, 128) for c in cts])), use_kernel=True)
    assert rows.shape == (got.hostmap_all.shape[0], 32)
    np.testing.assert_array_equal(words(rows), want)
    assert k6_spy == [sum(g.n_tiles * g.banks for g in got.groups)]


# ------------------------------------------------------------ the routes


@functools.lru_cache(maxsize=None)
def sparse_case():
    """(JAX plan, JAX sparse f32 field (all bricks), JAX schedule, port
    plan, port sparse field, port CPU schedule) on the stratified
    scene."""
    plan, field = scene(mode=J.SamplingMode.STRATIFIED)
    js = JSparse.from_dense(field, threshold=0.0)
    pplan = port_plan(plan)
    ps = P.SparseGridField.from_dense(port_field(field), threshold=0.0,
                                      device="cpu")
    jsched = j_tiled.build_tiled_schedule(plan, js,
                                          jitter=plan_jitter_table(plan))
    return (plan, js, jsched, pplan, ps,
            p_tiled.build_tiled_schedule(pplan, ps).to("cpu"))


def dl_image(plan, seed=4):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (plan.height, plan.width, 3)).astype(np.float32)


def port_sparse_grads():
    _, _, _, pplan, ps, sched = sparse_case()
    leaf = ps.with_params(ps.bricks.detach().clone())
    img = p_tiled.render_tiled(pplan, leaf, sched).image
    loss = torch.sum(img * torch.from_numpy(dl_image(pplan)))
    return torch.autograd.grad(loss, (leaf.bricks,))[0]


def test_split_sparse_render_tiled(monkeypatch, k6_spy):
    plan, js, jsched, _, ps, sched = sparse_case()
    assert ps.bricks.dtype == torch.float32
    set_split(monkeypatch, "xla")
    xla = port_sparse_grads()
    assert k6_spy == []
    set_split(monkeypatch, "pallas")
    split = port_sparse_grads()
    assert len(k6_spy) == 1 and len(sched.groups) > 0
    np.testing.assert_array_equal(words(split.reshape(-1, 32)),
                                  words(xla.reshape(-1, 32)))

    dl = jnp.asarray(dl_image(plan))

    def loss(bricks):
        return jnp.sum(j_tiled.render_tiled(
            plan, js.with_params(bricks), jsched,
            use_kernel=False).image * dl)

    want = jax.jit(jax.grad(loss))(js.bricks)
    assert float(jnp.abs(want).max()) > 0.0
    close(split.numpy(), want)


def test_split_renderer_backward_sparse(monkeypatch, k6_spy):
    plan, js, jsched, pplan, ps, sched = sparse_case()
    dl = dl_image(plan, seed=9).reshape(-1)

    def backward():
        r = P.Renderer(P.Context.create(device="cpu"), pplan,
                       P.RenderOptions(use_tiles=True))
        r.forward(ps)
        return r.backward(ps, dl)

    set_split(monkeypatch, "xla")
    xla = backward()
    assert k6_spy == []
    set_split(monkeypatch, "pallas")
    split = backward()
    assert len(k6_spy) == 1
    np.testing.assert_array_equal(split.bricks.view(np.int32),
                                  xla.bricks.view(np.int32))
    np.testing.assert_array_equal(split.camera, xla.camera)

    dlj = jnp.asarray(dl.reshape(plan.height, plan.width, 3))

    def loss(bricks):
        return jnp.sum(j_tiled.render_tiled(
            plan, js.with_params(bricks), jsched,
            use_kernel=False).image * dlj)

    close(split.bricks, jax.jit(jax.grad(loss))(js.bricks))


@functools.lru_cache(maxsize=None)
def stack_case():
    """(JAX plan, JAX field, JAX merged schedule, port plan, port field,
    port CPU merged schedule): the stratified scene's two views of
    tests/test_tiled.py:479-480, 16 px cells, quantized, merged."""
    plan, field = scene(mode=J.SamplingMode.STRATIFIED)
    jitter = plan_jitter_table(plan)
    cams = [J.CameraConfig(c2w=c) for c in VIEW_C2WS]
    jplans = j_fit.view_plans(plan, cams)
    jmerged = j_tiled.merge_view_schedules(
        [j_tiled.build_tiled_schedule(p, field, jitter=jitter, tile_px=16,
                                      quantize=True, device=False)
         for p in jplans], plans=jplans)
    pplan, pfield = port_plan(plan), port_field(field)
    pplans = p_fit.view_plans(pplan, [P.CameraConfig(c2w=c)
                                      for c in VIEW_C2WS])
    merged = p_tiled.merge_view_schedules(
        [p_tiled.build_tiled_schedule(p, pfield, tile_px=16, quantize=True)
         for p in pplans], plans=pplans).to("cpu")
    return plan, field, jmerged, pplan, pfield, merged


def test_split_dense_render_tiled_stack(monkeypatch, k6_spy):
    plan, field, jmerged, pplan, pfield, merged = stack_case()
    assert merged.sched.cell_scale == 1 and merged.n_views == 2
    dl = np.random.default_rng(6).uniform(
        -1.0, 1.0, (2, plan.height, plan.width, 3)).astype(np.float32)

    def grads():
        leaf = pfield.with_params(pfield.sigma.detach().clone(),
                                  pfield.color.detach().clone())
        img = p_tiled.render_tiled_stack(pplan, leaf, merged)
        return torch.autograd.grad(torch.sum(img * torch.from_numpy(dl)),
                                   (leaf.sigma, leaf.color))

    set_split(monkeypatch, "xla")
    xla = grads()
    assert k6_spy == []
    set_split(monkeypatch, "pallas")
    split = grads()
    assert len(k6_spy) == 1 and len(merged.sched.groups) > 0
    for a, b in zip(split, xla):
        np.testing.assert_array_equal(a.view(torch.int32).numpy(),
                                      b.view(torch.int32).numpy())

    def loss(sigma, color):
        img = j_tiled.render_tiled_stack(
            plan, field.with_params(sigma, color), jmerged,
            use_kernel=False)
        return jnp.sum(img * jnp.asarray(dl))

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(field.sigma, field.color)
    for a, b in zip(split, want):
        assert float(jnp.abs(b).max()) > 0.0
        close(a.numpy(), b)


@functools.lru_cache(maxsize=None)
def jax_fit_reference():
    """3 Adam steps (optax, lr 5e-2) from a flat field over JAX's merged
    views of the two cameras, its reference stack (``use_kernel=False``)
    under ``jax.grad``: (losses, sigma, color)."""
    plan, field = scene(mode=J.SamplingMode.STRATIFIED)
    cams = [J.CameraConfig(c2w=c) for c in VIEW_C2WS]
    init = field.with_params(jnp.full_like(field.sigma, 0.5),
                             jnp.full_like(field.color, 0.5))
    plans, merged, _ = j_fit._scheduled_views(plan, cams, init, "tiled")

    def render_stack(f, scheds):
        return j_tiled.render_tiled_stack(plan, f, scheds, use_kernel=False)

    opt = optax.adam(5e-2)
    step = j_fit.make_train_step_scheduled(
        plan, cams, init, opt, mode="tiled",
        views=(plans, merged, render_stack))
    params = (init.sigma, init.color)
    state = opt.init(params)
    targets = jnp.asarray(fit_targets(plan))
    losses = []
    for _ in range(FIT_STEPS):
        params, state, loss = step(params, init, state, targets)
        losses.append(float(loss))
    return losses, np.asarray(params[0]), np.asarray(params[1])


def fit_targets(plan):
    return np.random.default_rng(1).uniform(
        0.0, 1.0, (len(VIEW_C2WS), plan.height, plan.width, 3)
    ).astype(np.float32)


def test_split_fit_dense_grid(monkeypatch, k6_spy):
    plan, field = scene(mode=J.SamplingMode.STRATIFIED)
    pplan, pfield = port_plan(plan), port_field(field)
    init = pfield.with_params(torch.full_like(pfield.sigma, 0.5),
                              torch.full_like(pfield.color, 0.5))
    cams = [P.CameraConfig(c2w=c) for c in VIEW_C2WS]

    def fit():
        return p_fit.fit_dense_grid(
            pplan, init, cams, fit_targets(plan),
            p_fit.FitConfig(learning_rate=5e-2, steps=FIT_STEPS,
                            target_psnr=None), mode="tiled")

    set_split(monkeypatch, "xla")
    xla = fit()
    assert k6_spy == []
    set_split(monkeypatch, "pallas")
    split = fit()
    views = p_fit._scheduled_views(pplan, cams, init, "tiled")[1]
    assert views.sched.cell_scale == 1
    assert len(k6_spy) == FIT_STEPS and len(views.sched.groups) > 0
    assert split.mode == "tiled" and split.steps_run == FIT_STEPS
    assert split.loss_history == xla.loss_history
    for name in ("sigma", "color"):
        a = getattr(split.field, name).detach()
        b = getattr(xla.field, name).detach()
        np.testing.assert_array_equal(a.view(torch.int32).numpy(),
                                      b.view(torch.int32).numpy())
    losses, sigma, color = jax_fit_reference()
    np.testing.assert_allclose(split.loss_history, losses, rtol=LOSS_RTOL)
    assert split.loss_history[-1] < split.loss_history[0]
    np.testing.assert_allclose(split.field.sigma.detach().numpy(), sigma,
                               atol=FIELD_TOL)
    np.testing.assert_allclose(split.field.color.detach().numpy(), color,
                               atol=FIELD_TOL)


@pytest.mark.parametrize("route", ["dense", "supercell", "dense_bfloat16",
                                   "sparse_bfloat16"])
def test_routes_off_the_flag_make_no_k6_call(route, monkeypatch, k6_spy):
    plan, field = scene(mode=J.SamplingMode.STRATIFIED)
    pplan, pfield = port_plan(plan), port_field(field)
    kw = {}
    if route == "supercell":
        kw = dict(tile_px=8, cell_scale=2)
    elif route == "dense_bfloat16":
        pfield = pfield.with_packed_dtype("bfloat16")
    elif route == "sparse_bfloat16":
        pfield = P.SparseGridField.from_dense(pfield, threshold=0.0,
                                              dtype="bfloat16", device="cpu")
    sched = p_tiled.build_tiled_schedule(pplan, pfield, **kw).to("cpu")
    set_split(monkeypatch, "pallas")
    params = ((pfield.bricks,) if hasattr(pfield, "bricks")
              else (pfield.sigma, pfield.color))
    for p in params:
        p.requires_grad_(True)
    img = p_tiled.render_tiled(pplan, pfield, sched).image
    grads = torch.autograd.grad(torch.sum(img ** 2), params)
    assert all(float(g.abs().max()) > 0.0 for g in grads)
    assert k6_spy == []


# ----------------------------------------------------- the environment


CHILD = """
import numpy as np, torch
import dvren_tpu_torch as P
from dvren_tpu_torch.render import tiled
print("BWD_SPLIT", tiled.BWD_SPLIT)
n = 8
rng = np.random.default_rng(3)
plan = P.Plan.create(P.PlanConfig(
    width=16, height=16, t_near=0.1, t_far=3.1,
    camera=P.CameraConfig(k=(20.0, 0, 8, 0, 20.0, 8, 0, 0, 1),
                          c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.55, 0, 0, 1, -1.1)),
    sampling=P.SamplingConfig(dt=0.05, max_steps=60)))
field = P.DenseGridField.create(P.DenseGridConfig(
    resolution=(n, n, n), sigma=rng.uniform(0.5, 8.0, n ** 3),
    color=rng.uniform(0, 1, 3 * n ** 3), bbox_min=(0.3, 0.3, 0.2),
    bbox_max=(0.8, 0.9, 0.7)), device="cpu")
merged = tiled.merge_view_schedules(
    [tiled.build_tiled_schedule(plan, field)]).to("cpu")
img = tiled.render_tiled_stack(plan, field, merged)
print("forward ok")
try:
    img.sum().backward()
    print("backward ok", float(field.sigma.grad.abs().max()) > 0)
except ValueError as exc:
    print("backward raised:", exc)
"""


def run_child(value):
    env = dict(os.environ, DVREN_BWD_SPLIT=value, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_env_selects_the_split():
    lines = run_child("pallas")
    assert lines[0] == "BWD_SPLIT pallas"
    assert lines[1:] == ["forward ok", "backward ok True"]


def test_env_unknown_value_raises_at_backward():
    lines = run_child("bogus")
    assert lines[0] == "BWD_SPLIT bogus"
    assert lines[1] == "forward ok"
    assert lines[2].startswith("backward raised:")
    assert "'xla'" in lines[2] and "'pallas'" in lines[2]
    assert "'bogus'" in lines[2]
