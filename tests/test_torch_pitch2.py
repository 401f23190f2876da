"""Pitch 2, the cell-pair packing of the tile schedule, against dvren_tpu.

At pitch 2 a cell's lane is 2 * pair rank + (cell & 1) and the bank
gather reads one packed-row pair per index (``gathermap``). The schedules
equal the JAX package's; the sparse pair premise holds (a pair's even
cell at an even brick row) and an odd x dimension demotes a sparse field
to pitch 1. The port's render at pitch 2 is pitch 1's bit for bit, its
planes and its sigma, colour (or brick) and camera gradients, for dense
float32, bfloat16 and sparse fields, on a scene whose tiles group
differently at the two pitches: the backward sums over tiles in pitch
1's order at either pitch (``tiled._canonical_order``). Against JAX
(planes 5e-6, grid gradients 2e-6 x scale, camera rtol 2e-3 / atol 1e-4):
its reference consumer and its Renderer with ``tile_pitch=2``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from bench import _scene
from dvren_tpu.fields.sparse_grid import SparseGridField as JSparse
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import plan_jitter_table
from dvren_tpu.render.windowed import build_schedule, render_windowed_traced
from tests.test_tiled import scene as tiled_scene
from tests.test_torch_core import port_field, port_plan
from tests.test_torch_fused_tiles import assert_schedules_equal

import dvren_tpu_torch as P
from dvren_tpu_torch.render import tiled as p_tiled

torch.set_num_threads(1)

TOL = 5e-6
TOL_DEPTH = 1e-4
GRID_TOL = 2e-6
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4


@functools.lru_cache(maxsize=None)
def blob(kind):
    """The bench scene at 96^2 over 32^3 (64 steps) as a port field: dense
    float32, bfloat16, or sparse bricks."""
    plan, field = _scene(96, 96, 32, 64)
    pfield = port_field(field)
    if kind == "bfloat16":
        pfield = pfield.with_packed_dtype("bfloat16")
    elif kind == "sparse":
        pfield = P.SparseGridField.from_dense(pfield, threshold=0.0,
                                              device="cpu")
    return port_plan(plan), pfield


def render_grads(plan, field, sched):
    """(planes, (field param grads..., d c2w, d k)) of a weighted image
    sum through ``render_tiled`` with the plain twins."""
    if hasattr(field, "bricks"):
        leaf = field.with_params(field.bricks.detach().clone())
        params = (leaf.bricks,)
    else:
        leaf = field.with_params(field.sigma.detach().clone(),
                                 field.color.detach().clone())
        params = (leaf.sigma, leaf.color)
    for t in params:
        t.requires_grad_(True)
    k = torch.tensor(plan.camera.k, dtype=torch.float32).reshape(3, 3)
    c2w = torch.tensor(plan.camera.c2w, dtype=torch.float32).reshape(3, 4)
    k.requires_grad_(True)
    c2w.requires_grad_(True)
    planes = p_tiled.render_tiled(plan, leaf, sched.to("cpu"), k=k, c2w=c2w)
    w = torch.linspace(-1, 1, planes.image.numel()).reshape(
        planes.image.shape)
    loss = (torch.sum(planes.image * w) + 0.1 * torch.sum(planes.opacity)
            + 0.01 * torch.sum(planes.depth))
    return planes, torch.autograd.grad(loss, params + (c2w, k))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "sparse"])
def test_pitch2_renders_pitch1_bit_for_bit(kind):
    plan, field = blob(kind)
    s1 = p_tiled.build_tiled_schedule(plan, field, tile_px=8)
    s2 = p_tiled.build_tiled_schedule(plan, field, tile_px=8, pitch=2)
    assert s2.pitch == 2 and s1.fallback_rays == s2.fallback_rays == 0
    # the tiles group differently: the backward's order is what keeps it
    assert len(s1.groups) != len(s2.groups)
    a, ga = render_grads(plan, field, s1)
    b, gb = render_grads(plan, field, s2)
    for key in ("image", "transmittance", "opacity", "depth"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    for x, y in zip(ga, gb):
        assert float(x.abs().max()) > 0
        assert torch.equal(x, y)


def test_pitch2_gather_reads_row_pairs():
    """The pair gather lays the bank blocks out as the pitch-1 gather
    through ``hostmap`` does on every used lane, float32 and bfloat16."""
    plan, field = blob("float32")
    s2 = p_tiled.build_tiled_schedule(plan, field, tile_px=8, pitch=2)
    hm = torch.from_numpy(s2.hostmap_all)
    gm = torch.from_numpy(s2.gathermap_all)
    assert gm.numel() * 2 == hm.numel()
    table = torch.randn(p_tiled.fullpitch_rows(tuple(field.sigma.shape)), 32,
                        generator=torch.Generator().manual_seed(0))
    for t in (table, table.to(torch.bfloat16)):
        pair = p_tiled._gather_banks_flat(t, gm, 2)
        single = p_tiled._gather_banks_flat(t, hm, 1)
        used = (hm >= 0).reshape(-1, 128)[:, None, :].expand_as(pair)
        assert torch.equal(pair[used], single[used])
    with pytest.raises(P.DvrenError, match="even"):
        p_tiled._gather_banks_flat(table[:-1], gm, 2)


@functools.lru_cache(maxsize=None)
def sparse_case(grid):
    plan, field = _scene(64, 64, grid, 48)
    js = JSparse.from_dense(field, threshold=0.0)
    ps = P.SparseGridField.from_reference(
        np.asarray(js.bricks), np.asarray(js.occupancy), js.grid_shape,
        js.bbox_min, js.bbox_max, device="cpu")
    return plan, js, port_plan(plan), ps


def test_sparse_pair_premise():
    """Every used lane's brick row is its pair's row pair * 2 + (lane &
    1), and the schedule equals JAX's."""
    plan, js, pplan, ps = sparse_case(20)
    ref = j_tiled.build_tiled_schedule(plan, js, device=False,
                                       jitter=plan_jitter_table(plan),
                                       tile_px=8, pitch=2)
    got = p_tiled.build_tiled_schedule(pplan, ps, tile_px=8, pitch=2)
    assert got.pitch == 2
    assert_schedules_equal(ref, got)
    hm, gm = got.hostmap_all, got.gathermap_all
    valid = hm >= 0
    lane = np.arange(hm.size)
    np.testing.assert_array_equal(
        hm[valid], gm[lane[valid] // 2] * 2 + (lane[valid] & 1))


def test_odd_x_sparse_demotes_to_pitch1():
    plan, js, pplan, ps = sparse_case(21)
    ref = j_tiled.build_tiled_schedule(plan, js, device=False,
                                       jitter=plan_jitter_table(plan),
                                       tile_px=8, pitch=2)
    got = p_tiled.build_tiled_schedule(pplan, ps, tile_px=8, pitch=2)
    assert got.pitch == ref.pitch == 1
    assert_schedules_equal(ref, got)
    one = p_tiled.build_tiled_schedule(pplan, ps, tile_px=8)
    np.testing.assert_array_equal(got.gathermap_all, one.gathermap_all)


def test_merged_views_keep_pair_maps():
    """Merged pitch-2 views: the merged gathermap is the views' pair maps
    concatenated, as in JAX's merge."""
    plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED)
    pplan, pf = port_plan(plan), port_field(field)
    kw = dict(quantize="uniform", uniform_shape=(8, 4), pitch=2)
    refs = [j_tiled.build_tiled_schedule(plan, field, device=False,
                                         jitter=plan_jitter_table(plan),
                                         **kw)] * 2
    gots = [p_tiled.build_tiled_schedule(pplan, pf, **kw)] * 2
    ref = j_tiled.merge_view_schedules(refs)
    got = p_tiled.merge_view_schedules(gots)
    assert got.sched.pitch == 2
    np.testing.assert_array_equal(got.sched.gathermap_all,
                                  np.asarray(ref.sched.gathermap_all))
    np.testing.assert_array_equal(got.sched.hostmap_all,
                                  np.asarray(ref.sched.hostmap_all))
    stack = p_tiled.render_tiled_stack(pplan, pf, got.to("cpu"))
    one = p_tiled.render_tiled(pplan, pf, gots[0].to("cpu")).image
    assert torch.equal(stack[0], one) and torch.equal(stack[1], one)


# ------------------------------------------------------- against JAX


@functools.lru_cache(maxsize=None)
def small():
    plan, field = tiled_scene(mode=J.SamplingMode.STRATIFIED)
    ref = j_tiled.build_tiled_schedule(plan, field, device=False,
                                       jitter=plan_jitter_table(plan),
                                       pitch=2)
    got = p_tiled.build_tiled_schedule(port_plan(plan), port_field(field),
                                       pitch=2)
    return plan, field, ref, got


def close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * scale)


def test_small_scene_schedule_and_planes_match_jax():
    plan, field, ref, got = small()
    assert_schedules_equal(ref, got)
    want = j_tiled.render_tiled(plan, field, ref, use_kernel=False)
    with torch.no_grad():
        out = p_tiled.render_tiled(port_plan(plan), port_field(field),
                                   got.to("cpu"))
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(out, key).numpy(),
                                   np.asarray(getattr(want, key)), atol=TOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(out.depth.numpy(), np.asarray(want.depth),
                               atol=TOL_DEPTH, rtol=0)


def test_small_scene_grads_match_jax():
    """Grid gradients against ``jax.grad`` of JAX's reference consumer on
    its pitch-2 schedule; camera gradients against JAX's windowed path."""
    plan, field, _, got = small()
    jsched = j_tiled.build_tiled_schedule(plan, field, pitch=2,
                                          jitter=plan_jitter_table(plan))

    def loss(params):
        pls = j_tiled.render_tiled(plan, field.with_params(*params), jsched,
                                   use_kernel=False)
        return jnp.mean(pls.image ** 2) + 0.1 * jnp.mean(pls.opacity)

    want = jax.jit(jax.grad(loss))((field.sigma, field.color))
    pf = port_field(field)
    pls = p_tiled.render_tiled(port_plan(plan), pf, got.to("cpu"))
    out = torch.autograd.grad(torch.mean(pls.image ** 2)
                              + 0.1 * torch.mean(pls.opacity),
                              (pf.sigma, pf.color))
    for a, b in zip(out, want):
        close(a.numpy(), b, GRID_TOL)

    wsched = build_schedule(plan, field.bbox_min, field.bbox_max,
                            jitter=plan_jitter_table(plan))
    k0 = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
    c2w0 = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
    dl = np.random.default_rng(7).uniform(
        -1, 1, (plan.height, plan.width, 3)).astype(np.float32)

    def jloss(c2w, k):
        return jnp.sum(render_windowed_traced(plan, field, wsched, k=k,
                                              c2w=c2w).image * dl)

    cam_want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(c2w0, k0)
    c2w, k = (torch.tensor(a, requires_grad=True) for a in (c2w0, k0))
    img = p_tiled.render_tiled(port_plan(plan), pf, got.to("cpu"), k=k,
                               c2w=c2w).image
    cam = torch.autograd.grad(torch.sum(img * torch.from_numpy(dl)),
                              (c2w, k))
    for a, b in zip(cam, cam_want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CAM_RTOL,
                                   atol=CAM_ATOL)


def test_renderer_tile_pitch2_matches_jax_renderer():
    """``RenderOptions(tile_pitch=2)`` through both Renderers (tiles
    pinned on the JAX side, which picks them by default only on a TPU);
    the port's backward equals its pitch-1 backward bit for bit."""
    plan, field, _, _ = small()
    ref = J.Renderer(J.Context.create(), plan,
                     J.RenderOptions(use_tiles=True, tile_pitch=2)
                     ).forward(field)
    ctx = P.Context.create(device="cpu")
    r2 = P.Renderer(ctx, port_plan(plan),
                    P.RenderOptions(use_tiles=True, tile_pitch=2))
    r1 = P.Renderer(ctx, port_plan(plan), P.RenderOptions(use_tiles=True))
    pf = port_field(field)
    got = r2.forward(pf)
    for key in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(getattr(got, key),
                                   np.asarray(getattr(ref, key)).reshape(-1),
                                   atol=TOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(got.depth, np.asarray(ref.depth).reshape(-1),
                               atol=TOL_DEPTH, rtol=0)
    r1.forward(pf)
    dl = np.random.default_rng(3).uniform(
        -1, 1, plan.ray_count * 3).astype(np.float32)
    g1, g2 = r1.backward(pf, dl), r2.backward(pf, dl)
    for key in ("sigma", "color", "camera", "camera_k"):
        np.testing.assert_array_equal(getattr(g2, key), getattr(g1, key),
                                      err_msg=key)


def lane_id_scene():
    """One 16x16 tile over a 64 x 64 x 192 grid, 96 fixed steps: every
    sample of a 4 px sub-tile's chunk lands in its own cell, so the 16 px
    and 8 px tables overflow and the cascade ends at 4 px, where pitch 1
    needs 161 banks a tile and pitch 2, its runs padded to cell pairs,
    more than the 255 the 15-bit lane id can name."""
    plan = J.Plan.create(J.PlanConfig(
        width=16, height=16, t_near=0.05, t_far=1.05, seed=2,
        camera=J.CameraConfig(k=(8.0, 0, 8.0, 0, 8.0, 8.0, 0, 0, 1),
                              c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                   -0.05)),
        sampling=J.SamplingConfig(dt=1.0 / 96, max_steps=96)))
    rng = np.random.default_rng(0)
    voxels = 64 * 64 * 192
    field = J.DenseGridField.create(J.DenseGridConfig(
        resolution=(64, 64, 192), sigma=rng.uniform(0.1, 1.0, voxels),
        color=rng.uniform(0, 1, 3 * voxels)))
    return plan, field


def test_pitch2_cascade_lane_id_refusal_matches_jax():
    """The pitch-2 cascade that reaches the 15-bit lane-id refusal at
    4 px (ROADMAP Queue 3): JAX's schedule builder refuses, and so does the
    port's, with the same error; pitch 1 builds the same 4 px schedule in
    both. A defect of the reference, shared on purpose: the port does not
    demote to pitch 1."""
    plan, field = lane_id_scene()
    pplan, pfield = port_plan(plan), port_field(field)
    with pytest.raises(J.DvrenError) as ref:
        j_tiled.build_tiled_schedule_auto(plan, field, pitch=2, device=False)
    with pytest.raises(P.DvrenError) as got:
        p_tiled.build_tiled_schedule_auto(pplan, pfield, pitch=2)
    assert "15-bit lane id" in str(ref.value)
    assert str(got.value) == str(ref.value)
    ref1, note1 = j_tiled.build_tiled_schedule_auto(plan, field, pitch=1,
                                                    device=False)
    got1, note = p_tiled.build_tiled_schedule_auto(pplan, pfield, pitch=1)
    assert note == note1 == "tiled_subtiled_4px"
    assert [g.banks for g in got1.groups] == [161]
    assert_schedules_equal(ref1, got1)
    with pytest.raises(P.DvrenError, match="15-bit lane id"):
        P.Renderer(P.Context.create(device="cpu"), pplan,
                   P.RenderOptions(use_tiles=True, tile_pitch=2)
                   ).forward(pfield)
