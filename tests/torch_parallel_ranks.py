"""Rank functions and scenes for tests/test_torch_parallel.py.

The ranks are spawned processes (``dvren_tpu_torch.parallel.launch``),
which import the module of the function they run: this one imports no
JAX, so neither do they. The scenes are built from numpy through either
package's constructors (``pkg`` is ``dvren_tpu`` or ``dvren_tpu_torch``),
so the test holds both packages to the same inputs. Each rank function
runs its cases on every rank and returns rank 0's results as numpy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch.core.status import DvrenError
from dvren_tpu_torch.opt.fit import (FitConfig, _scheduled_views,
                                     fit_dense_grid, mse)
from dvren_tpu_torch.parallel import mesh as mesh_mod
from dvren_tpu_torch.parallel import shard
from dvren_tpu_torch.render import tiled
from dvren_tpu_torch.render.pipeline import render

THREADS = 2       # torch threads per CPU rank
FIT_STEPS = 3     # Adam steps of the fits held to each other


def _field(pkg, config, device):
    kw = {} if device is None else {"device": device}
    return pkg.DenseGridField.create(config, **kw)


def parallel_scene(pkg, width=16, height=16, device=None):
    """tests/test_parallel.py::make_scene: a random 6^3 grid."""
    rng = np.random.default_rng(1)
    n = 6
    plan = pkg.Plan.create(pkg.PlanConfig(
        width=width, height=height, t_near=0.3, t_far=2.3,
        camera=pkg.CameraConfig(
            k=(width * 1.4, 0, width / 2, 0, width * 1.4, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=pkg.SamplingConfig(dt=0.1, max_steps=20)))
    field = _field(pkg, pkg.DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.5, 5.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3)), device)
    return plan, field


def dp_poses(n_views=8):
    """tests/test_parallel.py's view-DP poses: a row in x."""
    return np.asarray([(1, 0, 0, 0.5 + 0.02 * i, 0, 1, 0, 0.5, 0, 0, 1,
                        -1.0) for i in range(n_views)], np.float32)


def z_scene(pkg, mode="FIXED", n=17, width=32, height=24, device=None):
    """tests/test_zsharded.py::scene: a random n^3 grid in a bbox."""
    rng = np.random.default_rng(11)
    plan = pkg.Plan.create(pkg.PlanConfig(
        width=width, height=height, t_near=0.15, t_far=2.4, seed=9,
        camera=pkg.CameraConfig(
            k=(width * 1.1, 0, width / 2, 0, width * 1.1, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -0.9)),
        sampling=pkg.SamplingConfig(dt=0.05, max_steps=48,
                                    mode=getattr(pkg.SamplingMode, mode))))
    field = _field(pkg, pkg.DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.2, 6.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3),
        bbox_min=(0.15, 0.1, 0.1), bbox_max=(0.9, 0.95, 0.85)), device)
    return plan, field


# name -> (z_scene keywords, sigma scale): FIXED, STRATIFIED, optically
# thick, 11 cells (uneven), 5 cells (an empty slab over 4 ranks)
Z_CASES = {
    "fixed": (dict(), 1.0),
    "stratified": (dict(mode="STRATIFIED"), 1.0),
    "thick": (dict(), 300.0),
    "cells11": (dict(n=12), 1.0),
    "cells5": (dict(n=6), 1.0),
}


def multiview_scene(pkg, device=None):
    """tests/test_parallel.py::test_tile_dp_multiview_step_matches_single_
    chip's scene: two views at 48^2 over a 32^3 blob (8 px supercells)."""
    n, wh, n_views = 32, 48, 2
    zs, ys, xs = np.meshgrid(*[np.linspace(0, 1, n)] * 3, indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (12.0 * np.exp(-r2 / 0.05)).astype(np.float32)
    color = np.stack([xs, ys, 1.0 - zs], -1).astype(np.float32)
    plan = pkg.Plan.create(pkg.PlanConfig(
        width=wh, height=wh, t_near=0.2, t_far=2.2, seed=3,
        camera=pkg.CameraConfig(
            k=(wh * 1.2, 0, wh / 2, 0, wh * 1.2, wh / 2, 0, 0, 1)),
        sampling=pkg.SamplingConfig(dt=2.0 / 32, max_steps=32)))
    field = _field(pkg, pkg.DenseGridConfig(
        resolution=(n,) * 3, sigma=sigma.reshape(-1),
        color=color.reshape(-1)), device)
    cams = [pkg.CameraConfig(c2w=(
        1, 0, 0, 0.5 + 0.2 * math.sin(2 * math.pi * i / n_views),
        0, 1, 0, 0.5 + 0.1 * math.cos(2 * math.pi * i / n_views),
        0, 0, 1, -1.0)) for i in range(n_views)]
    return plan, field, cams


def _np(x):
    return x.detach().cpu().numpy()


def _planes(p) -> dict:
    return {k: _np(getattr(p, k)) for k in ("image", "transmittance",
                                            "opacity", "depth", "hitmask")}


def _equal(a, b) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("image", "transmittance", "opacity", "depth",
                         "hitmask"))


def _sgd_grads(field, trained) -> list:
    """(old - new) of an SGD step at lr 1: the step's gradients."""
    return [_np(field.sigma - trained.sigma),
            _np(field.color - trained.color)]


def _ranks_agree(mesh, field) -> bool:
    """Every rank's parameters equal rank 0's, bit for bit: each rank
    writes its flat parameters into its row of a zero (D, n) array and
    one sum gathers the rows."""
    flat = torch.cat([field.sigma.detach().reshape(-1),
                      field.color.detach().reshape(-1)])
    rows = torch.zeros((mesh.size, flat.numel()), device=flat.device)
    rows[mesh.rank] = flat
    rows = mesh_mod.all_reduce_sum(mesh, rows)
    return bool((rows == rows[0:1]).all())


def ray_view_cases(mesh) -> dict:
    """Mesh creation, the ray-sharded frame, the view-DP step and fit,
    and the z-sharded frames."""
    torch.set_num_threads(THREADS)
    out = dict(size=mesh.size, rank=mesh.rank, backend=mesh.backend)
    try:
        mesh_mod.make_mesh(mesh.size + 1, device="cpu")
        out["too_many_raises"] = False
    except ValueError:
        out["too_many_raises"] = True
    if not torch.cuda.is_available():
        try:
            mesh_mod.make_mesh(mesh.size)
            out["cuda_default_raises"] = False
        except DvrenError:
            out["cuda_default_raises"] = True
    # a mesh over the first two ranks: a new group; the others get None
    sub = mesh_mod.make_mesh(2, device="cpu")
    if sub is not None:
        x = torch.full((3,), float(sub.rank + 1))
        out["sub_mesh_sum"] = _np(mesh_mod.all_reduce_sum(sub, x))
    out["sub_mesh_none"] = (sub is None) == (mesh.rank >= 2)

    # the ray-sharded frame, against pipeline.render
    plan, field = parallel_scene(P, 16, 16, device="cpu")
    with torch.no_grad():
        sharded = shard.render_sharded(plan, field, mesh)
        single = render(plan, field).planes
    out["ray_planes"] = _planes(sharded)
    out["ray_bit_equal"] = _equal(sharded, single)
    plan, field = z_scene(P, mode="STRATIFIED", device="cpu")
    with torch.no_grad():
        out["ray_stratified_bit_equal"] = _equal(
            shard.render_sharded(plan, field, mesh),
            render(plan, field).planes)

    # the view-DP step (SGD at lr 1: the update is the gradient)
    plan, field = parallel_scene(P, 8, 8, device="cpu")
    c2ws = torch.from_numpy(dp_poses()).reshape(-1, 3, 4)
    targets = torch.zeros((8, plan.height, plan.width, 3))
    trained = shard._leaf_copy(field)
    step = shard.make_dp_train_step(
        plan, trained, torch.optim.SGD(trained.parameters(), lr=1.0), mesh)
    out["dp_loss"] = float(step(c2ws, targets))
    out["dp_grads"] = _sgd_grads(field, trained)
    out["dp_ranks_agree"] = _ranks_agree(mesh, trained)
    try:
        step(c2ws[:3], targets[:3])
        out["dp_step_indivisible_raises"] = False
    except ValueError:
        out["dp_step_indivisible_raises"] = True

    # fit_dense_grid_dp toward the field's own renders
    cams = [P.CameraConfig(c2w=tuple(float(v) for v in p))
            for p in dp_poses()]
    with torch.no_grad():
        views = np.stack([_np(render(plan, field, c2w=c).planes.image)
                          for c in c2ws])
    init = field.with_params(torch.full_like(field.sigma, 1.0),
                             torch.full_like(field.color, 0.5))
    _, losses = shard.fit_dense_grid_dp(plan, init, cams, views, mesh,
                                        learning_rate=5e-2, steps=40)
    out["fit_losses"] = losses
    try:
        shard.fit_dense_grid_dp(plan, field, cams[:3], views[:3], mesh)
        out["fit_indivisible_raises"] = False
    except ValueError:
        out["fit_indivisible_raises"] = True

    # the z-sharded frames (forward only: refused with gradients on)
    plan, field = z_scene(P, device="cpu")
    try:
        shard.render_zsharded(plan, field, mesh)
        out["z_grad_refused"] = False
    except DvrenError as err:
        out["z_grad_refused"] = "forward-only" in str(err)
    for name, (kw, scale) in Z_CASES.items():
        plan, field = z_scene(P, device="cpu", **kw)
        if scale != 1.0:
            field = field.with_params(field.sigma.detach() * scale,
                                      field.color.detach())
        with torch.no_grad():
            out[f"z_{name}"] = _planes(shard.render_zsharded(plan, field,
                                                             mesh))
    return out


def tiled_cases(mesh) -> dict:
    """The tile-sharded frame and steps through the tile kernels' twins."""
    torch.set_num_threads(THREADS)
    out = {}
    # the frame and a tile-DP step on the 48x32 scene
    plan, field = parallel_scene(P, 48, 32, device="cpu")
    sched = tiled.build_tiled_schedule(plan, field)
    shards = shard.shard_tiled_schedule(sched, mesh.size)
    with torch.no_grad():
        sharded = shard.render_tiled_sharded(plan, field, sched, mesh,
                                             shards=shards)
        single = tiled.render_tiled(plan, field, sched.to("cpu"))
    out["tiled_planes"] = _planes(sharded)
    out["tiled_bit_equal"] = _equal(sharded, single)
    # the other table routes: a bfloat16 table (K5a) and sparse bricks
    for name, other in (
            ("bfloat16", field.with_packed_dtype("bfloat16")),
            ("sparse", P.SparseGridField.from_dense(field, threshold=0.0,
                                                    device="cpu"))):
        s_other = tiled.build_tiled_schedule(plan, other)
        with torch.no_grad():
            out[f"tiled_{name}_bit_equal"] = _equal(
                shard.render_tiled_sharded(plan, other, s_other, mesh),
                tiled.render_tiled(plan, other, s_other.to("cpu")))
    target = torch.zeros((plan.height, plan.width, 3))
    grads = []
    for _ in range(2):      # a repeat from the same start: the same bits
        trained = shard._leaf_copy(field)
        step = shard.make_tile_dp_train_step(
            plan, trained, torch.optim.SGD(trained.parameters(), lr=1.0),
            mesh, sched)
        out["tile_dp_loss"] = float(step(shards, target))
        grads.append(_sgd_grads(field, trained))
    out["tile_dp_grads"] = grads[0]
    out["tile_dp_summed_grads"] = [_np(trained.sigma.grad),
                                   _np(trained.color.grad)]
    out["tile_dp_repeat_equal"] = all(np.array_equal(a, b)
                                      for a, b in zip(*grads))
    out["tile_dp_ranks_agree"] = _ranks_agree(mesh, trained)
    ref = shard._leaf_copy(field)
    mse(tiled.render_tiled(plan, ref, sched.to("cpu")).image,
        target).backward()
    out["tile_dp_port_grads"] = [_np(ref.sigma.grad), _np(ref.color.grad)]

    # one 16 px tile: every rank but 0 holds dead tiles only
    plan, field = parallel_scene(P, 16, 16, device="cpu")
    sched = tiled.build_tiled_schedule(plan, field)
    with torch.no_grad():
        sharded = shard.render_tiled_sharded(plan, field, sched, mesh)
        single = tiled.render_tiled(plan, field, sched.to("cpu"))
    out["empty_bit_equal"] = _equal(sharded, single)
    out["empty_rank_plan_none"] = (
        shard.rank_schedule(sched, shard.shard_tiled_schedule(
            sched, mesh.size), mesh.size - 1).gather_plan is None)
    trained = shard._leaf_copy(field)
    step = shard.make_tile_dp_train_step(
        plan, trained, torch.optim.SGD(trained.parameters(), lr=1.0), mesh,
        sched)
    step(None, torch.zeros((plan.height, plan.width, 3)))
    out["empty_grads"] = _sgd_grads(field, trained)

    # balance on the 64x64 scene
    plan, field = parallel_scene(P, 64, 64, device="cpu")
    sched = tiled.build_tiled_schedule(plan, field)
    out["balance"] = [shard.live_tiles_per_rank(g) for g in
                      shard.shard_tiled_schedule(sched, mesh.size)]

    # the multi-view supercell step against render_tiled_stack
    plan, field, cams = multiview_scene(P, device="cpu")
    _, merged, render_stack = _scheduled_views(plan, cams, field, "tiled")
    out["mv_form"] = (merged.sched.cell_scale, merged.sched.tile_px,
                      merged.sched.fallback_rays)
    targets = torch.zeros((len(cams), plan.height, plan.width, 3))
    trained = shard._leaf_copy(field)
    step, mv_shards = shard.make_tile_dp_multiview_step(
        plan, trained, torch.optim.SGD(trained.parameters(), lr=1.0), mesh,
        merged)
    out["mv_loss"] = float(step(mv_shards, targets))
    out["mv_grads"] = _sgd_grads(field, trained)
    out["mv_summed_grads"] = [_np(trained.sigma.grad),
                              _np(trained.color.grad)]
    ref = shard._leaf_copy(field)
    loss = mse(render_stack(ref, merged), targets)
    loss.backward()
    out["mv_ref_loss"] = float(loss.detach())
    out["mv_ref_grads"] = [_np(ref.sigma.grad), _np(ref.color.grad)]

    # fit_dense_grid_tile_dp against the single-device tiled fit
    flat = field.with_params(torch.full_like(field.sigma, 1.0),
                             torch.full_like(field.color, 0.5))
    with torch.no_grad():
        views = render_stack(field, merged)
    _, losses = shard.fit_dense_grid_tile_dp(plan, flat, cams, views, mesh,
                                             steps=FIT_STEPS)
    out["tile_fit_losses"] = losses
    out["tile_fit_targets"] = _np(views)
    out["single_fit_losses"] = np.asarray(fit_dense_grid(
        plan, flat, cams, views,
        FitConfig(learning_rate=5e-2, steps=FIT_STEPS, target_psnr=None),
        mode="tiled").loss_history)
    return out


def fallback_fit_case(mesh) -> dict:
    """``fit_dense_grid_tile_dp`` on merged schedules that carry fallback
    rays runs ``fit_dense_grid_dp``, as JAX's does: here the merged
    schedule is marked with one fallback ray."""
    torch.set_num_threads(THREADS)
    plan, field = parallel_scene(P, 8, 8, device="cpu")
    cams = [P.CameraConfig(c2w=tuple(float(v) for v in p))
            for p in dp_poses()]
    with torch.no_grad():
        views = np.stack([_np(render(plan, field, c2w=torch.tensor(
            c.c2w).reshape(3, 4)).planes.image) for c in cams])
    orig = shard._scheduled_views

    def marked(*args, **kw):
        plans, merged, render_stack = orig(*args, **kw)
        return plans, dataclasses.replace(merged, sched=dataclasses.replace(
            merged.sched, fallback_rays=1)), render_stack

    shard._scheduled_views = marked
    try:
        _, routed = shard.fit_dense_grid_tile_dp(plan, field, cams, views,
                                                 mesh, steps=FIT_STEPS)
    finally:
        shard._scheduled_views = orig
    _, direct = shard.fit_dense_grid_dp(plan, field, cams, views, mesh,
                                        steps=FIT_STEPS)
    return dict(routed=routed, direct=direct)


def all_cases(mesh) -> dict:
    """Every case of one mesh in one spawn (a spawn costs seconds)."""
    return {**ray_view_cases(mesh), **tiled_cases(mesh),
            **{f"fallback_{k}": v for k, v in fallback_fit_case(mesh)
               .items()}}


def tile_dp_case(mesh) -> dict:
    """The tile-sharded frame and one tile-DP step on the 48x32 scene on
    the mesh's device, with the single-device ``render_tiled`` frame and
    autograd gradients (rank 0) and a repeat step's gradients."""
    dev = mesh.device
    plan, field = parallel_scene(P, 48, 32, device=dev)
    field.requires_grad_(False)
    sched = tiled.build_tiled_schedule(plan, field)
    target = torch.zeros((plan.height, plan.width, 3), device=dev)
    with torch.no_grad():
        frame = shard.render_tiled_sharded(plan, field, sched, mesh)
        ref = tiled.render_tiled(plan, field, sched.to(dev))
    grads = []
    for _ in range(2):
        trained = shard._leaf_copy(field)
        shard.make_tile_dp_train_step(
            plan, trained, torch.optim.SGD(trained.parameters(), lr=1.0),
            mesh, sched)(None, target)
        grads.append([_np(trained.sigma.grad), _np(trained.color.grad)])
    ref_field = shard._leaf_copy(field)
    mse(tiled.render_tiled(plan, ref_field, sched.to(dev)).image,
        target).backward()
    return dict(device=str(dev), backend=mesh.backend,
                frame_bit_equal=_equal(frame, ref), grads=grads[0],
                repeat_grads=grads[1],
                ref_grads=[_np(ref_field.sigma.grad),
                           _np(ref_field.color.grad)])


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a sum that rank 1 never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh_mod.all_reduce_sum(mesh, torch.ones(1))
