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


# ------------------------------------------- the recorded sharded steps

GRAPH_STEPS = 3     # replays held to the eager body, per step


def _words(t) -> torch.Tensor:
    return t.detach().reshape(-1).float().view(torch.int32)


def _adam(f):
    """optax.adam's defaults at lr 5e-2 (the CPU's: not capturable)."""
    return torch.optim.Adam(f.parameters(), lr=5e-2, betas=(0.9, 0.999),
                            eps=1e-8)


def _same_state(fa, oa, fb, ob) -> bool:
    """Parameters and Adam's state bit for bit."""
    pa, pb = list(fa.parameters()), list(fb.parameters())
    if not all(torch.equal(_words(a), _words(b)) for a, b in zip(pa, pb)):
        return False
    for a, b in zip(pa, pb):
        sa, sb = oa.state[a], ob.state[b]
        if sorted(sa) != sorted(sb):
            return False
        for k in sa:
            if not torch.equal(_words(torch.as_tensor(sa[k])),
                               _words(torch.as_tensor(sb[k]))):
                return False
    return True


def _replays(captured, make, fresh) -> dict:
    """A step recorded through the stand-in against the eager body of a
    twin step from the same start, GRAPH_STEPS each: the losses, the
    parameters and Adam's state bit for bit, one recording, each loss its
    own tensor; then the step on new inputs (a new shards object or c2ws
    tensor) records anew. ``make(f, opt) -> (step, inputs, new
    inputs)``."""
    fa, fb = fresh(), fresh()
    oa, ob = _adam(fa), _adam(fb)
    (sa, inputs, again), (sb, _, _) = make(fa, oa), make(fb, ob)
    n0 = len(captured)
    la = [sa(*inputs) for _ in range(GRAPH_STEPS)]
    lb = [sb.body(*inputs) for _ in range(GRAPH_STEPS)]
    out = dict(recordings=len(captured) - n0,
               graph_is_the_recording=sa.graph is captured[-1],
               losses_equal=all(torch.equal(_words(a), _words(b))
                                for a, b in zip(la, lb)),
               state_equal=_same_state(fa, oa, fb, ob),
               distinct=len({x.data_ptr() for x in la}) == GRAPH_STEPS,
               losses=[float(x) for x in la])
    sa(*again)
    out["new_inputs_record"] = len(captured) - n0 == 2
    return out


def _no_table(standin):
    """``pipeline.plan_jitter_table`` refused for the duration."""
    from dvren_tpu_torch.render import pipeline

    def refuse(*args, **kwargs):
        raise AssertionError("the host jitter table was read")

    return standin.patched((pipeline, "plan_jitter_table", refuse))


def graph_cases(mesh) -> dict:
    """The recorded sharded steps on CPU ranks, through the stand-in of
    tests/torch_graph_standin.py: the tile-DP, multi-view tile-DP and
    view-DP steps' replays against their eager bodies, new inputs
    recording anew, the recorded runs uploading nothing; the graphed fits
    against the eager fits; a non-capturable Adam refused on the recorded
    path; on the gloo mesh itself the steps eager (``graph`` None); the
    jitter of the ray-sharded frame, the view-DP step and the z-sharded
    frame hashed, never read from the host table, bit-equal to the table
    route. (The stand-in is imported here, from the repository's tests:
    the card's tests import this module where another ``tests`` package
    may come first.)"""
    from dvren_tpu_torch.ops.raygen import generate_rays
    from dvren_tpu_torch.ops.sampling import generate_samples
    from dvren_tpu_torch.render.pipeline import plan_jitter_table
    from tests import torch_graph_standin as standin

    torch.set_num_threads(THREADS)
    out = {}
    project = shard._project_field

    # the steps' scenes: the 48x32 tile-DP scene, the two-view supercell
    # scene, the stratified z scene with four poses for view DP
    plan, field = parallel_scene(P, 48, 32, device="cpu")
    sched = tiled.build_tiled_schedule(plan, field)
    shards = shard.shard_tiled_schedule(sched, mesh.size)
    target = torch.zeros((plan.height, plan.width, 3))

    def tile_make(f, opt):
        return (shard.make_tile_dp_train_step(plan, f, opt, mesh, sched,
                                              project=project),
                (shards, target),
                (shard.shard_tiled_schedule(sched, mesh.size), target))

    mplan, mfield, mcams = multiview_scene(P, device="cpu")
    _, merged, render_stack = _scheduled_views(mplan, mcams, mfield, "tiled")
    with torch.no_grad():
        mtargets = 0.7 * render_stack(mfield, merged)

    def mv_make(f, opt):
        step, mshards = shard.make_tile_dp_multiview_step(
            mplan, f, opt, mesh, merged, project=project)
        return (step, (mshards, mtargets),
                (shard.shard_tiled_schedule(
                    merged.sched, mesh.size,
                    global_tile_ids=shard.merged_global_tile_ids(
                        mplan, merged)), mtargets))

    vplan, vfield = z_scene(P, mode="STRATIFIED", device="cpu")
    c2ws = torch.from_numpy(dp_poses(4)).reshape(-1, 3, 4)
    with torch.no_grad():
        vtargets = torch.stack([render(vplan, vfield, c2w=c).planes.image
                                for c in c2ws])
    vflat = vfield.with_params(torch.full_like(vfield.sigma, 1.0),
                               torch.full_like(vfield.color, 0.5))

    def dp_make(f, opt):
        return (shard.make_dp_train_step(vplan, f, opt, mesh,
                                         project=project),
                (c2ws, vtargets), (c2ws.clone(), vtargets))

    fresh = {"tile": lambda: shard._leaf_copy(field),
             "multiview": lambda: shard._leaf_copy(mfield),
             "view_dp": lambda: shard._leaf_copy(vflat)}
    makes = {"tile": tile_make, "multiview": mv_make, "view_dp": dp_make}
    with standin.installed() as captured:
        for name, make in makes.items():
            out[name] = _replays(captured, make, fresh[name])
        # the graphed fits: one recording each
        mflat = mfield.with_params(torch.full_like(mfield.sigma, 1.0),
                                   torch.full_like(mfield.color, 0.5))
        vcams = [P.CameraConfig(c2w=tuple(float(v) for v in c.reshape(-1)))
                 for c in c2ws]
        n0 = len(captured)
        _, tile_fit = shard.fit_dense_grid_tile_dp(
            mplan, mflat, mcams, mtargets, mesh, steps=FIT_STEPS)
        _, dp_fit = shard.fit_dense_grid_dp(
            vplan, vflat, vcams, vtargets, mesh, steps=FIT_STEPS)
        out["fit_recordings"] = len(captured) - n0
    # the same fits eagerly, on the gloo mesh as it is
    _, tile_eager = shard.fit_dense_grid_tile_dp(
        mplan, mflat, mcams, mtargets, mesh, steps=FIT_STEPS)
    _, dp_eager = shard.fit_dense_grid_dp(vplan, vflat, vcams, vtargets,
                                          mesh, steps=FIT_STEPS)
    out.update(tile_fit=tile_fit, dp_fit=dp_fit,
               fit_targets=_np(mtargets), dp_fit_targets=_np(vtargets),
               fits_equal_eager=(np.array_equal(tile_fit, tile_eager)
                                 and np.array_equal(dp_fit, dp_eager)))

    # a non-capturable Adam on the recorded path: refused, field untouched
    with standin.installed(capturable_check=True):
        f = fresh["tile"]()
        step, inputs, _ = tile_make(f, _adam(f))
        try:
            step(*inputs)
            out["noncapturable_raises"] = False
        except DvrenError as err:
            out["noncapturable_raises"] = "capturable=True" in str(err)
        out["noncapturable_untouched"] = (
            torch.equal(f.sigma, field.sigma)
            and torch.equal(f.color, field.color) and step.graph is None)

    # the gloo mesh as it is: every step runs its body (the eager fits
    # above equal the graphed ones), no graph
    out["record_device"] = shard.record_device(mesh)
    eager = {}
    for name, make in makes.items():
        f = fresh[name]()
        step, inputs, _ = make(f, _adam(f))
        eager[name] = (bool(torch.isfinite(step(*inputs)))
                       and step.graph is None)
    out["gloo_eager"] = eager

    # the jitter hashed on the device: no host table read, bit-equal to
    # the table route
    table = torch.from_numpy(plan_jitter_table(vplan).copy())
    with torch.no_grad():
        ray_ref = render(vplan, vfield, jitter=table).planes
        z_ref = shard.render_zsharded(vplan, vfield, mesh, jitter=table)
        with _no_table(standin):
            ray = shard.render_sharded(vplan, vfield, mesh)
            z = shard.render_zsharded(vplan, vfield, mesh)
            start, count, _, _, lattice = shard.ray_shard_lattice(
                vplan, vfield, mesh)
        rows = generate_samples(
            vplan, generate_rays(vplan, start=start, count=count,
                                 device="cpu"),
            jitter=table[start:start + count])
    out["ray_table_bit_equal"] = _equal(ray, ray_ref)
    out["z_table_bit_equal"] = _equal(z, z_ref)
    out["lattice_table_bit_equal"] = (torch.equal(lattice.t, rows.t)
                                      and torch.equal(lattice.mask,
                                                      rows.mask))
    # the view-DP step (SGD at lr 1: the update is the gradient) against
    # autograd through the table route on one device
    f = shard._leaf_copy(vfield)
    step = shard.make_dp_train_step(
        vplan, f, torch.optim.SGD(f.parameters(), lr=1.0), mesh)
    zeros = torch.zeros_like(vtargets)
    with _no_table(standin):
        out["dp_loss"] = float(step(c2ws, zeros))
    out["dp_grads"] = _sgd_grads(vfield, f)
    out["dp_summed_grads"] = [_np(f.sigma.grad), _np(f.color.grad)]
    ref = shard._leaf_copy(vfield)
    loss = mse(torch.stack([render(vplan, ref, c2w=c, jitter=table)
                            .planes.image for c in c2ws]), zeros)
    loss.backward()
    out["dp_ref_loss"] = float(loss.detach())
    out["dp_ref_grads"] = [_np(ref.sigma.grad), _np(ref.color.grad)]
    return out


def tile_dp_graph_case(mesh, steps=5) -> dict:
    """The tile-DP step on the mesh's device with a capturable Adam:
    ``steps`` calls of the step (recorded once on an NCCL CUDA mesh, then
    replayed) against the eager body of a twin step from the same start,
    the launch counters around both, and the recording's launches."""
    from dvren_tpu_torch.render import graph

    dev = mesh.device
    plan, field = parallel_scene(P, 48, 32, device=dev)
    sched = tiled.build_tiled_schedule(plan, field)
    target = torch.zeros((plan.height, plan.width, 3), device=dev)
    fa, fb = shard._leaf_copy(field), shard._leaf_copy(field)
    oa, ob = (torch.optim.Adam(f.parameters(), lr=5e-2, betas=(0.9, 0.999),
                               eps=1e-8, capturable=dev.type == "cuda")
              for f in (fa, fb))
    sa, sb = (shard.make_tile_dp_train_step(plan, f, o, mesh, sched,
                                            project=shard._project_field)
              for f, o in ((fa, oa), (fb, ob)))
    graph.reset_launch_counts()
    la = torch.stack([sa(None, target) for _ in range(steps)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    moved = {k: v for k, v in graph.launch_counts().items() if v}
    lb = torch.stack([sb.body(None, target) for _ in range(steps)])
    return dict(backend=mesh.backend, device=str(dev),
                recorded=None if sa.graph is None else dict(sa.graph.launches),
                moved=moved, losses=_np(la),
                state_equal=(torch.equal(_words(la), _words(lb))
                             and _same_state(fa, oa, fb, ob)))


def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a sum that rank 1 never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh_mod.all_reduce_sum(mesh, torch.ones(1))
