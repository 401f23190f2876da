"""dvren_tpu_torch.parallel against dvren_tpu.parallel, on the CPU.

Host products in this process, at D = 8, array for array:
``shard_tiled_schedule``'s per-rank tile arrays (16 px cells, a frame
of one tile, and a merged multi-view 8 px supercell schedule with global
tile ids), each rank's gather plan against JAX's union-padded ``gidx[d]``
with its pad entries taken out, ``merged_global_tile_ids`` and
``build_z_slabs`` (11 cells over 8 ranks, 5 over 4: an empty slab).

The sharded paths run on ranks spawned by ``launch`` over gloo, at D = 2
and D = 4, one spawn each (tests/torch_parallel_ranks.py, which imports
no JAX), and are held to JAX's single-device functions at JAX's own
tolerances (tests/test_parallel.py, tests/test_zsharded.py) and, where
tier 1 runs it, to JAX's sharded function on a 4-device mesh:

- the mesh: its size and backend, a ``ValueError`` past the world
  size, a ``DvrenError`` when it would default to an absent CUDA device,
  a sub-mesh over two ranks;
- the ray-sharded frame: bit-equal to the port's ``pipeline.render``
  (FIXED and STRATIFIED), within 1e-5 of JAX's, hitmask equal;
- the view-DP step: loss within rel 1e-5, gradients within rtol 1e-4 /
  atol 1e-6 (SGD at lr 1); ``fit_dense_grid_dp`` halves the loss; a view
  count the mesh does not divide raises ``ValueError``;
- the z-sharded frame, FIXED, STRATIFIED, optically thick (sigma x 300),
  11 cells and 5 cells (an empty slab at D = 4): within 2e-5, depth 1e-4;
  refused (``DvrenError``) with gradients on;
- the tile-sharded frame: bit-equal to the port's ``render_tiled``,
  within 1e-6 of JAX's (depth 1e-5), and bit-equal on a bfloat16 table
  and on sparse bricks; tile-DP gradients (the update of
  an SGD step at lr 1) within rtol 1e-3 / atol 5e-7 of ``jax.grad``, and
  the summed gradients within 2e-6 x scale of the port's single-device
  autograd; a repeat step bit-identical, the ranks' parameters equal; a
  16x16 frame whose ranks past 0 hold dead tiles only: bit-equal,
  gradients as above; balance;
- the multi-view supercell step against ``jax.grad`` through JAX's plain
  ``render_tiled_stack`` on the same merged schedule: the loss within rel
  1e-5, the update and the summed gradients within rtol 1e-3 / atol
  5e-7, and the summed gradients within 2e-6 x scale of the port's own
  ``render_tiled_stack``; ``fit_dense_grid_tile_dp``'s losses within rel
  1e-4 of JAX's ``fit_dense_grid(mode="tiled")`` and of the port's, and
  its route to ``fit_dense_grid_dp`` when the merged schedule has
  fallback rays;
- ``dryrun_multichip(2, device="cpu")`` at a small flagship.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvren_tpu as J
from dvren_tpu.opt import fit as j_fit
from dvren_tpu.parallel import mesh as j_mesh
from dvren_tpu.parallel import shard as j_shard
from dvren_tpu.render import tiled as j_tiled
from dvren_tpu.render.pipeline import render as j_render
from tests import torch_parallel_ranks as R

import dvren_tpu_torch as P
from dvren_tpu_torch.ops.gather_plan import slot_rows_to_table
from dvren_tpu_torch.opt import fit as p_fit
from dvren_tpu_torch.parallel import Mesh, launch, shard
from dvren_tpu_torch.parallel.dryrun import dryrun_multichip
from dvren_tpu_torch.render import tiled as p_tiled
from dvren_tpu_torch.render.pipeline import render as p_render

torch.set_num_threads(1)

N_HOST = 8          # ranks of the host-product checks (JAX's test mesh)
RANKS = (2, 4)      # ranks of the spawned checks
DROP = 1 << 30
REPO = Path(__file__).resolve().parents[1]
KEYS = ("samp", "base", "rayt", "bank0", "k_enter", "hostmap", "tile_ids")


@functools.lru_cache(maxsize=None)
def ranks_run(n_dev):
    """Every spawned case at ``n_dev`` ranks, run once per process."""
    return launch(R.all_cases, n_dev, backend="gloo", device="cpu")


def jax_mesh4():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 JAX devices (tests/conftest.py makes 8)")
    return j_mesh.make_mesh(4)


def assert_planes_close(got, ref, tol, depth_tol, hitmask=True):
    for k in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k)),
                                   rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(got["depth"], np.asarray(ref.depth), rtol=0,
                               atol=depth_tol, err_msg="depth")
    if hitmask:
        np.testing.assert_array_equal(got["hitmask"],
                                      np.asarray(ref.hitmask))


# ------------------------------------------------------------ host products


@functools.lru_cache(maxsize=None)
def jax_multiview():
    """JAX's multi-view scene and its merged schedule: (plan, field,
    cameras, merged)."""
    jp, jf, jc = R.multiview_scene(J)
    _, jm, _ = j_fit._scheduled_views(jp, jc, jf, "tiled")
    return jp, jf, jc, jm


@functools.lru_cache(maxsize=None)
def host_case(name):
    """(JAX schedule, port schedule, JAX global ids or None, port global
    ids or None) of a named schedule."""
    if name == "multiview":
        jp, _, _, jm = jax_multiview()
        pp, pf, pc = R.multiview_scene(P, device="cpu")
        _, pm, _ = p_fit._scheduled_views(pp, pc, pf, "tiled")
        return (jm.sched, pm.sched, j_shard.merged_global_tile_ids(jp, jm),
                shard.merged_global_tile_ids(pp, pm))
    wh = {"48x32": (48, 32), "64x64": (64, 64), "16x16": (16, 16)}[name]
    jp, jf = R.parallel_scene(J, *wh)
    pp, pf = R.parallel_scene(P, *wh, device="cpu")
    return (j_tiled.build_tiled_schedule(jp, jf),
            p_tiled.build_tiled_schedule(pp, pf), None, None)


HOST_CASES = ("48x32", "64x64", "16x16", "multiview")


@pytest.mark.parametrize("name", HOST_CASES)
def test_shard_tiled_schedule_equals_jax(name):
    js, ps, jids, pids = host_case(name)
    want = j_shard.shard_tiled_schedule(js, N_HOST, global_tile_ids=jids)
    got = shard.shard_tiled_schedule(ps, N_HOST, global_tile_ids=pids)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(KEYS) <= set(g)
        for k in KEYS:
            wk = np.asarray(w[k])
            assert g[k].dtype == wk.dtype, k
            np.testing.assert_array_equal(g[k], wk, err_msg=k)


@pytest.mark.parametrize("name", HOST_CASES)
def test_rank_plans_equal_jax_without_pads(name):
    js, ps, _, _ = host_case(name)
    _, gidx, _ = j_shard._shard_gather_plans(js, N_HOST)
    shards = shard.shard_tiled_schedule(ps, N_HOST)
    s_dev = sum(g["hostmap"][0].size for g in shards)
    n_rows = int(ps.gather_plan.inv_map.shape[0])
    rng = np.random.default_rng(5)
    for d in range(N_HOST):
        rs = shard.rank_schedule(ps, shards, d)
        real = gidx[d][gidx[d] != s_dev]
        assert rs.pitch == 1 and rs.fallback_rays == 0
        np.testing.assert_array_equal(rs.hostmap_all, rs.gathermap_all)
        if rs.gather_plan is None:
            assert real.size == 0 and (rs.hostmap_all < 0).all()
            continue
        np.testing.assert_array_equal(rs.gather_plan.all_idx, real)
        # the plan's sums equal a scatter-add of the rank's slot rows
        rows = rng.standard_normal((rs.hostmap_all.size, 3)).astype(
            np.float32)
        live = rs.hostmap_all >= 0
        ref = np.zeros((n_rows, 3), np.float64)
        np.add.at(ref, rs.hostmap_all[live], rows[live])
        got = slot_rows_to_table(torch.from_numpy(rows),
                                 rs.gather_plan.to("cpu"), n_rows)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_rank_schedule_arrays_are_the_rank_slice():
    _, ps, _, _ = host_case("48x32")
    shards = shard.shard_tiled_schedule(ps, N_HOST)
    for d in (0, 3, N_HOST - 1):
        rs = shard.rank_schedule(ps, shards, d)
        for g, sh in zip(rs.groups, shards):
            for k in ("samp", "base", "rayt", "bank0", "k_enter",
                      "tile_ids"):
                np.testing.assert_array_equal(getattr(g, k), sh[k][d])
            np.testing.assert_array_equal(g.hostmap,
                                          sh["hostmap"][d].reshape(-1))
            assert g.samples == int(((sh["samp"][d][:, :, 2] >> 15) & 1)
                                    .sum())


def test_rank_schedule_built_once_per_shards():
    """Every sharded tile path takes its rank schedule from one cache:
    the same schedule and shards give the same built schedule, other
    shards or another rank another one."""
    _, ps, _, _ = host_case("48x32")
    cpu = torch.device("cpu")
    mesh = Mesh(group=None, rank=1, size=N_HOST, device=cpu, backend="gloo")
    shards = shard.shard_tiled_schedule(ps, N_HOST)
    built = shard._rank_tiles(ps, shards, mesh)
    assert shard._rank_tiles(ps, shards, mesh) is built
    own = shard._rank_tiles(ps, None, mesh)     # the schedule's own slices
    assert own is not built and shard._rank_tiles(ps, None, mesh) is own
    for a, b in zip(own.groups, built.groups):
        assert torch.equal(a.samp, b.samp) and a.samp.device == cpu
    rank2 = dataclasses.replace(mesh, rank=2)
    assert shard._rank_tiles(ps, shards, rank2) is not built
    for a, sh in zip(shard._rank_tiles(ps, shards, rank2).groups, shards):
        np.testing.assert_array_equal(a.samp.numpy(), sh["samp"][2])


def test_merged_global_tile_ids_equal_jax():
    _, _, jids, pids = host_case("multiview")
    assert len(pids) == len(jids)
    for g, w in zip(pids, jids):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n, n_dev", [(17, 8), (12, 8), (6, 4), (6, 8)])
def test_build_z_slabs_equals_jax(n, n_dev):
    _, jf = R.z_scene(J, n=n)
    _, pf = R.z_scene(P, n=n, device="cpu")
    want = j_shard.build_z_slabs(jf, n_dev)
    got = shard.build_z_slabs(pf, n_dev)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if (n, n_dev) == (6, 4):     # 5 cells over 4: the last slab is empty
        assert int(got[2][-1]) == int(got[3][-1]) == 5


def test_balance_bound_at_jax_mesh_size():
    """JAX's tests/test_parallel.py::test_tile_shards_balanced bound, at
    its mesh size, on the port's slices."""
    _, ps, _, _ = host_case("64x64")
    for g in shard.shard_tiled_schedule(ps, N_HOST):
        per = shard.live_tiles_per_rank(g)
        assert per.max() - per.min() <= 8, per


# ------------------------------------------------------------ ray and view DP


@pytest.mark.parametrize("n_dev", RANKS)
def test_mesh_creation(n_dev):
    out = ranks_run(n_dev)
    assert (out["size"], out["rank"], out["backend"]) == (n_dev, 0, "gloo")
    assert out["too_many_raises"]
    assert out.get("cuda_default_raises", True)
    assert out["sub_mesh_none"]
    np.testing.assert_array_equal(out["sub_mesh_sum"], np.full(3, 3.0))


@pytest.mark.parametrize("n_dev", RANKS)
def test_ray_sharded_matches_single_device(n_dev):
    out = ranks_run(n_dev)
    assert out["ray_bit_equal"] and out["ray_stratified_bit_equal"]
    jp, jf = R.parallel_scene(J, 16, 16)
    assert_planes_close(out["ray_planes"], j_render(jp, jf).planes, 1e-5,
                        1e-5)


def test_ray_sharded_matches_jax_sharded():
    jp, jf = R.parallel_scene(J, 16, 16)
    assert_planes_close(ranks_run(4)["ray_planes"],
                        j_shard.render_sharded(jp, jf, jax_mesh4()), 1e-5,
                        1e-5)


@functools.lru_cache(maxsize=None)
def jax_dp_reference():
    jp, jf = R.parallel_scene(J, 8, 8)
    c2ws = jnp.asarray(R.dp_poses()).reshape(-1, 3, 4)
    targets = jnp.zeros((8, jp.height, jp.width, 3), jnp.float32)

    def loss_fn(p):
        f = jf.with_params(*p)
        pred = jax.vmap(lambda c: j_render(jp, f, c2w=c).planes.image)(c2ws)
        return jnp.mean((pred - targets) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)((jf.sigma, jf.color))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n_dev", RANKS)
def test_dp_train_step_matches_single_device_grads(n_dev):
    out = ranks_run(n_dev)
    loss, grads = jax_dp_reference()
    assert out["dp_loss"] == pytest.approx(loss, rel=1e-5)
    for got, ref in zip(out["dp_grads"], grads):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert out["dp_ranks_agree"]


@functools.lru_cache(maxsize=None)
def port_dp_reference():
    """The view-DP step's loss and gradient on one device: autograd of
    the MSE over the 8 poses through the port's ``pipeline.render``."""
    plan, field = R.parallel_scene(P, 8, 8, device="cpu")
    f = field.with_params(field.sigma.detach().clone(),
                          field.color.detach().clone())
    c2ws = torch.from_numpy(R.dp_poses()).reshape(-1, 3, 4)
    pred = torch.stack([p_render(plan, f, c2w=c).planes.image
                        for c in c2ws])
    loss = torch.mean(pred ** 2)
    loss.backward()
    return float(loss.detach()), [f.sigma.grad.numpy(), f.color.grad.numpy()]


@pytest.mark.parametrize("n_dev", RANKS)
def test_dp_step_gradient_is_the_single_device_gradient(n_dev):
    """Across ranks, the gradient (an SGD step at lr 1) is the one-device
    gradient of the same loss on the port (loss rel 1e-5; rtol 1e-4 /
    atol 1e-6, the parameters' float32 ulp)."""
    out = ranks_run(n_dev)
    loss, grads = port_dp_reference()
    assert out["dp_loss"] == pytest.approx(loss, rel=1e-5)
    for got, ref in zip(out["dp_grads"], grads):
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_dev", RANKS)
def test_fit_dense_grid_dp_reduces_loss(n_dev):
    losses = ranks_run(n_dev)["fit_losses"]
    assert losses.shape == (40,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5
    # the first loss: the flat field's views against the truth's, in JAX
    jp, jf = R.parallel_scene(J, 8, 8)
    init = jf.with_params(jnp.full_like(jf.sigma, 1.0),
                          jnp.full_like(jf.color, 0.5))
    c2ws = jnp.asarray(R.dp_poses()).reshape(-1, 3, 4)
    views = jnp.stack([j_render(jp, jf, c2w=c).planes.image for c in c2ws])
    pred = jnp.stack([j_render(jp, init, c2w=c).planes.image for c in c2ws])
    assert losses[0] == pytest.approx(float(jnp.mean((pred - views) ** 2)),
                                      rel=1e-5)


@pytest.mark.parametrize("n_dev", RANKS)
def test_view_count_must_divide_mesh(n_dev):
    out = ranks_run(n_dev)
    assert out["fit_indivisible_raises"]
    assert out["dp_step_indivisible_raises"]


# ------------------------------------------------------------- z-slab sharding


@functools.lru_cache(maxsize=None)
def jax_z_case(name):
    kw, scale = R.Z_CASES[name]
    jp, jf = R.z_scene(J, **kw)
    if scale != 1.0:
        jf = jf.with_params(jf.sigma * scale, jf.color)
    return jp, jf


@pytest.mark.parametrize("n_dev", RANKS)
@pytest.mark.parametrize("name", tuple(R.Z_CASES))
def test_zsharded_matches_single_device(n_dev, name):
    jp, jf = jax_z_case(name)
    assert_planes_close(ranks_run(n_dev)[f"z_{name}"],
                        j_render(jp, jf).planes, 2e-5, 1e-4)


@pytest.mark.parametrize("n_dev", RANKS)
def test_zsharded_refuses_gradients(n_dev):
    """The slabs are host copies of the field: with gradients on for a
    field that requires them, the frame raises instead of dropping them."""
    assert ranks_run(n_dev)["z_grad_refused"]


@pytest.mark.parametrize("name", ("fixed", "cells5"))
def test_zsharded_matches_jax_zsharded(name):
    jp, jf = jax_z_case(name)
    assert_planes_close(ranks_run(4)[f"z_{name}"],
                        j_shard.render_zsharded(jp, jf, jax_mesh4()), 2e-5,
                        1e-4)


# ------------------------------------------------------------- tile sharding


def jax_tiled_grads(width, height):
    jp, jf = R.parallel_scene(J, width, height)
    sched = j_tiled.build_tiled_schedule(jp, jf)
    target = jnp.zeros((jp.height, jp.width, 3), jnp.float32)

    def loss_fn(p):
        f = jf.with_params(*p)
        img = j_tiled.render_tiled(jp, f, sched, use_kernel=False).image
        return jnp.mean((img - target) ** 2)

    return [np.asarray(g) for g in jax.grad(loss_fn)((jf.sigma, jf.color))]


@pytest.mark.parametrize("n_dev", RANKS)
def test_tiled_sharded_matches_single_chip(n_dev):
    out = ranks_run(n_dev)
    assert out["tiled_bit_equal"]
    jp, jf = R.parallel_scene(J, 48, 32)
    ref = j_tiled.render_tiled(jp, jf, j_tiled.build_tiled_schedule(jp, jf),
                               use_kernel=False)
    got = out["tiled_planes"]
    np.testing.assert_allclose(got["image"], np.asarray(ref.image), atol=1e-6)
    np.testing.assert_allclose(got["depth"], np.asarray(ref.depth), atol=1e-5)
    np.testing.assert_allclose(got["transmittance"],
                               np.asarray(ref.transmittance), atol=1e-6)


@pytest.mark.parametrize("n_dev", RANKS)
@pytest.mark.parametrize("route", ("bfloat16", "sparse"))
def test_tiled_sharded_other_table_routes_bit_equal(n_dev, route):
    """A bfloat16 table (K5a) and sparse bricks through the rank's
    schedule: bit-equal to render_tiled on the same schedule."""
    assert ranks_run(n_dev)[f"tiled_{route}_bit_equal"]


def test_tiled_sharded_matches_jax_sharded():
    jp, jf = R.parallel_scene(J, 48, 32)
    ref = j_shard.render_tiled_sharded(
        jp, jf, j_tiled.build_tiled_schedule(jp, jf), jax_mesh4())
    assert_planes_close(ranks_run(4)["tiled_planes"], ref, 1e-6, 1e-5)


@pytest.mark.parametrize("n_dev", RANKS)
def test_tile_dp_train_step_matches_single_chip_grads(n_dev):
    out = ranks_run(n_dev)
    assert np.isfinite(out["tile_dp_loss"])
    for got, ref in zip(out["tile_dp_grads"], jax_tiled_grads(48, 32)):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-7)
    # the summed gradients themselves (the update above is quantized at
    # the parameters' ulp) against the port's single-device autograd
    for got, port in zip(out["tile_dp_summed_grads"],
                         out["tile_dp_port_grads"]):
        np.testing.assert_allclose(got, port, rtol=0,
                                   atol=2e-6 * np.abs(port).max())


@pytest.mark.parametrize("n_dev", RANKS)
def test_tile_dp_repeat_step_is_bit_identical(n_dev):
    out = ranks_run(n_dev)
    assert out["tile_dp_repeat_equal"]
    assert out["tile_dp_ranks_agree"]


@pytest.mark.parametrize("n_dev", RANKS)
def test_tile_dp_grads_with_empty_rank_shards(n_dev):
    out = ranks_run(n_dev)
    assert out["empty_bit_equal"]
    assert out["empty_rank_plan_none"]
    for got, ref in zip(out["empty_grads"], jax_tiled_grads(16, 16)):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-7)


@pytest.mark.parametrize("n_dev", RANKS)
def test_tile_shards_balanced(n_dev):
    """No rank holds more than 8 tiles past an even share of a group's
    live tiles: what contiguous slices of ceil(T / 8D) * 8 tiles
    guarantee (JAX's max - min <= 8 holds at D = 8 only; see
    dvren_tpu_torch/parallel/dryrun.py)."""
    want = j_shard.shard_tiled_schedule(host_case("64x64")[0], n_dev)
    for per, w in zip(ranks_run(n_dev)["balance"], want):
        live = (np.asarray(w["tile_ids"]) < DROP).reshape(n_dev, -1)
        np.testing.assert_array_equal(per, live.sum(axis=1))
        assert per.max() <= -(-int(per.sum()) // n_dev) + 8, per


@functools.lru_cache(maxsize=None)
def jax_multiview_grads():
    """The loss and ``jax.grad`` of the mean square of JAX's plain
    ``render_tiled_stack`` against zero targets, on JAX's merged
    schedule of the multi-view scene."""
    jp, jf, jc, jm = jax_multiview()
    targets = jnp.zeros((len(jc), jp.height, jp.width, 3), jnp.float32)

    def loss_fn(p):
        stack = j_tiled.render_tiled_stack(jp, jf.with_params(*p), jm,
                                           use_kernel=False)
        return jnp.mean((stack - targets) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)((jf.sigma, jf.color))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n_dev", RANKS)
def test_tile_dp_multiview_step_matches_single_chip(n_dev):
    """Against JAX's single-device merged stack at JAX's tolerances
    (tests/test_parallel.py::test_tile_dp_multiview_step_matches_single_
    chip), and against the port's own stack."""
    out = ranks_run(n_dev)
    cell_scale, tile_px, fallback = out["mv_form"]
    assert cell_scale == 2 and tile_px < 16 and fallback == 0
    loss, grads = jax_multiview_grads()
    assert out["mv_loss"] == pytest.approx(loss, rel=1e-5)
    for got, ref in zip(out["mv_grads"], grads):
        assert float(np.abs(ref).max()) > 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-7)
    for got, ref in zip(out["mv_summed_grads"], grads):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-7)
    assert out["mv_loss"] == pytest.approx(out["mv_ref_loss"], rel=1e-5)
    for got, ref in zip(out["mv_summed_grads"], out["mv_ref_grads"]):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def jax_tiled_fit_losses(targets_bytes, shape):
    """JAX's ``fit_dense_grid(mode="tiled")`` on the multi-view scene from
    the flat start the ranks fit from (sigma 1, colour 0.5), toward the
    given targets."""
    jp, jf, jc, _ = jax_multiview()
    flat = jf.with_params(jnp.full_like(jf.sigma, 1.0),
                          jnp.full_like(jf.color, 0.5))
    targets = np.frombuffer(targets_bytes, np.float32).reshape(shape)
    return np.asarray(j_fit.fit_dense_grid(
        jp, flat, list(jc), targets,
        j_fit.FitConfig(learning_rate=5e-2, steps=R.FIT_STEPS,
                        target_psnr=None), mode="tiled").loss_history)


@pytest.mark.parametrize("n_dev", RANKS)
def test_fit_dense_grid_tile_dp_matches_the_tiled_fit(n_dev):
    """Adam over the sharded multi-view step against ``fit_dense_grid``'s
    tiled mode on one device, JAX's and the port's: the same schedules,
    optimizer and projection (tests/test_torch_fit.py's loss
    tolerance)."""
    out = ranks_run(n_dev)
    got, want = out["tile_fit_losses"], out["single_fit_losses"]
    targets = np.ascontiguousarray(out["tile_fit_targets"], np.float32)
    jax_losses = jax_tiled_fit_losses(targets.tobytes(), targets.shape)
    assert got.shape == want.shape == jax_losses.shape == (R.FIT_STEPS,)
    np.testing.assert_allclose(got, jax_losses, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("n_dev", RANKS)
def test_fit_dense_grid_tile_dp_routes_fallback_to_view_dp(n_dev):
    out = ranks_run(n_dev)
    np.testing.assert_array_equal(out["fallback_routed"],
                                  out["fallback_direct"])


# ------------------------------------------------------------------ dry run


def test_dryrun_multichip_on_cpu_ranks(monkeypatch):
    monkeypatch.setenv("DVREN_DRYRUN_FIT_VIEWS", "2")
    monkeypatch.setenv("DVREN_DRYRUN_FIT_WIDTH", "96")
    monkeypatch.setenv("OMP_NUM_THREADS", str(R.THREADS))
    out = dryrun_multichip(2, device="cpu")
    assert out["n_devices"] == 2 and out["backend"] == "gloo"
    assert out["zsharded_parity"] < 1e-4
    assert out["tiled_parity"] < 1e-5 and out["tile_groups"] >= 2
    assert out["multiview_grad_parity"] < 5e-6
    f = out["fit_losses"]
    assert f[2] < f[1] < f[0]


def test_rank_modules_leave_jax_out():
    """What spawned ranks import (the rank functions' modules) pulls in
    neither JAX nor dvren_tpu."""
    code = ("import sys, tests.torch_parallel_ranks, "
            "dvren_tpu_torch.parallel.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dvren_tpu')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch(R.fail_on_rank_1, 2, backend="gloo", device="cpu")
