"""The multi-device check: every sharded path once, with its assertions.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: the same sequence
at the same sizes, run on ``n_devices`` ranks spawned by
:func:`~dvren_tpu_torch.parallel.mesh.launch`:

1. a view-DP Adam step (one 8x8 view per rank, 8^3 grid, 8 steps);
2. the ray-sharded frame, finite;
3. the z-sharded frame within 1e-4 of ``pipeline.render``;
4. the tile-sharded frame at 128^2 over 16^3 (64 steps): at least two
   tile groups, no fallback, no rank with more than 8 live tiles past an
   even share of a group's, within 1e-5 of ``render_tiled``; a tile-DP
   Adam step;
5. the fit flagship (``DVREN_DRYRUN_FIT_VIEWS`` views, default 8, at
   ``DVREN_DRYRUN_FIT_WIDTH`` px, default 96, over 64^3): the merged
   schedule of 8 px supercells (``cell_scale == 2``, ``tile_px < 16``, no
   fallback), a multi-view tile-DP SGD step (lr 1) whose gradients are
   within 5e-6 of autograd through ``render_tiled_stack``, then three
   Adam steps whose loss falls strictly.

Rank 0 holds each result against its single-device reference and prints
one summary line; a failed check raises there, which fails the run.

The balance check differs from JAX's, which asks that the live tiles per
device differ by at most 8. That holds on its scene at D = 8 only: the
slices are contiguous runs of ceil(T / 8D) * 8 tiles of a group padded at
its end, so a rank holds a full slice, a partial one or none (JAX's own
slices give [16, 4] live tiles at D = 2 and [16, 16, 4, 0] at D = 4 for
its third group). The port's slices equal JAX's, and it checks the bound
they guarantee: no rank more than 8 tiles past an even share.

    python -c "from dvren_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2, backend='gloo')"
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch.opt.fit import _scheduled_views, mse
from dvren_tpu_torch.parallel.mesh import Mesh, launch
from dvren_tpu_torch.parallel import shard
from dvren_tpu_torch.render import tiled
from dvren_tpu_torch.render.pipeline import render


def _require(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def flagship_scene(width=128, height=128, grid_n=64, max_steps=64,
                   device=None):
    """``__graft_entry__.py::_flagship_scene`` in numpy: a Gaussian blob
    (sigma 12 exp(-r^2 / 0.05)) coloured by position on a grid_n^3 grid,
    seen by a pinhole camera at z = -1 over [0.2, 2.2] with stratified
    steps of 2 / max_steps (seed 3). Returns (plan, field)."""
    zs, ys, xs = np.meshgrid(
        np.linspace(0, 1, grid_n), np.linspace(0, 1, grid_n),
        np.linspace(0, 1, grid_n), indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (12.0 * np.exp(-r2 / 0.05)).astype(np.float32)
    color = np.stack([xs, ys, 1.0 - zs], axis=-1).astype(np.float32)
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.2, t_far=2.2, seed=3,
        camera=P.CameraConfig(
            k=(width * 1.2, 0.0, width / 2, 0.0, width * 1.2, height / 2,
               0.0, 0.0, 1.0),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / max_steps, max_steps=max_steps,
                                  mode=P.SamplingMode.STRATIFIED)))
    field = P.DenseGridField.create(P.DenseGridConfig(
        resolution=(grid_n,) * 3, sigma=sigma.reshape(-1),
        color=color.reshape(-1)), device=device)
    return plan, field


def flagship_cameras(n_views: int):
    """The fit flagship's translation orbit (``tools/fit_benchmark.py``)."""
    return [P.CameraConfig(c2w=(
        1, 0, 0, 0.5 + 0.2 * math.sin(2 * math.pi * i / n_views),
        0, 1, 0, 0.5 + 0.1 * math.cos(2 * math.pi * i / n_views),
        0, 0, 1, -1.0)) for i in range(n_views)]


def _dryrun_rank(mesh: Mesh) -> dict:
    dev, n_dev, lead = mesh.device, mesh.size, mesh.rank == 0

    # view-DP step: one view per rank
    plan, field = flagship_scene(width=8, height=8, grid_n=8, max_steps=8,
                                 device=dev)
    c2ws = torch.tensor([(1, 0, 0, 0.5 + 0.01 * i, 0, 1, 0, 0.5, 0, 0, 1,
                          -1.0) for i in range(n_dev)],
                        dtype=torch.float32, device=dev).reshape(-1, 3, 4)
    targets = torch.zeros((n_dev, plan.height, plan.width, 3), device=dev)
    dp_field = shard._trainable_copy(field, mesh)
    step = shard.make_dp_train_step(plan, dp_field,
                                    shard._adam(dp_field, 1e-2), mesh)
    loss = step(c2ws, targets)
    _require(math.isfinite(float(loss)),
             "dp train step produced non-finite loss")

    # ray-sharded frame
    planes = shard.render_sharded(plan, field, mesh)
    _require(bool(torch.isfinite(planes.image).all()),
             "ray-sharded frame not finite")

    # z-sharded frame: 1/D of the grid per rank plus the halo plane
    with torch.no_grad():
        zplanes = shard.render_zsharded(plan, field, mesh)
    zdiff = 0.0
    if lead:
        with torch.no_grad():
            ref = render(plan, field).planes
        zdiff = float((zplanes.image - ref.image).abs().max())
        _require(zdiff < 1e-4, f"z-sharded parity {zdiff}")

    # the fused tile kernels across the ranks: 128^2 rays, several groups
    plan_t, field_t = flagship_scene(width=128, height=128, grid_n=16,
                                     max_steps=64, device=dev)
    sched = tiled.build_tiled_schedule(plan_t, field_t)
    _require(len(sched.groups) >= 2 and sched.fallback_rays == 0,
             "the 128^2 schedule needs >= 2 groups and no fallback")
    shards = shard.shard_tiled_schedule(sched, n_dev)
    for g in shards:
        per_rank = shard.live_tiles_per_rank(g)
        share = -(-int(per_rank.sum()) // n_dev)
        _require(per_rank.max() <= share + 8,
                 f"unbalanced tile shard: {per_rank}")
    with torch.no_grad():
        tplanes = shard.render_tiled_sharded(plan_t, field_t, sched, mesh,
                                             shards=shards)
    tdiff = 0.0
    if lead:
        with torch.no_grad():
            tref = tiled.render_tiled(plan_t, field_t, sched.to(dev))
        tdiff = float((tplanes.image - tref.image).abs().max())
        _require(tdiff < 1e-5, f"sharded tiled parity {tdiff}")
    t_field = shard._trainable_copy(field_t, mesh)
    t_step = shard.make_tile_dp_train_step(
        plan_t, t_field, shard._adam(t_field, 1e-2), mesh, sched,
        project=shard._project_field)
    t_loss = t_step(shards, torch.zeros((plan_t.height, plan_t.width, 3),
                                        device=dev))
    _require(math.isfinite(float(t_loss)), "tile-DP step non-finite loss")

    # the fit flagship's multi-view supercell step, with gradient parity
    m_views = int(os.environ.get("DVREN_DRYRUN_FIT_VIEWS", "8"))
    m_w = int(os.environ.get("DVREN_DRYRUN_FIT_WIDTH", "96"))
    plan_m, field_m = flagship_scene(width=m_w, height=m_w, grid_n=64,
                                     max_steps=64, device=dev)
    cams = flagship_cameras(m_views)
    _, merged, render_stack = _scheduled_views(plan_m, cams, field_m,
                                               "tiled")
    _require(merged.sched.cell_scale == 2,
             "coarse views must pick supercell")
    _require(merged.sched.tile_px < 16, "flagship views must sub-tile")
    _require(merged.sched.fallback_rays == 0, "flagship views fall back")
    with torch.no_grad():
        m_targets = 0.7 * render_stack(field_m, merged)
    m_field = shard._trainable_copy(field_m, mesh)
    m_step, m_shards = shard.make_tile_dp_multiview_step(
        plan_m, m_field, torch.optim.SGD(m_field.parameters(), lr=1.0),
        mesh, merged)
    m_step(m_shards, m_targets)
    m_gdiff = 0.0
    if lead:
        ref_field = shard._leaf_copy(field_m)
        mse(render_stack(ref_field, merged), m_targets).backward()
        m_gdiff = max(
            float(((old - new) - p.grad).detach().abs().max())
            for old, new, p in ((field_m.sigma, m_field.sigma,
                                 ref_field.sigma),
                                (field_m.color, m_field.color,
                                 ref_field.color)))
        _require(m_gdiff < 5e-6, f"multi-view tile-DP grad parity {m_gdiff}")

    # three Adam steps of the flagship fit: the loss falls
    f_field = shard._trainable_copy(field_m, mesh)
    f_step, f_shards = shard.make_tile_dp_multiview_step(
        plan_m, f_field, shard._adam(f_field, 2e-2), mesh, merged)
    f_losses = [float(f_step(f_shards, m_targets)) for _ in range(3)]
    _require(f_losses[2] < f_losses[1] < f_losses[0],
             f"flagship sharded fit loss not decreasing: {f_losses}")

    # a views/s figure of the view-DP step (its first step warmed it up)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        step(c2ws, targets)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    views_s = 3 * n_dev / (time.perf_counter() - t0)
    out = dict(n_devices=n_dev, backend=mesh.backend, device=str(dev),
               zsharded_parity=zdiff, tiled_parity=tdiff,
               tile_groups=len(sched.groups),
               multiview_grad_parity=m_gdiff, fit_losses=f_losses,
               views_per_s=views_s)
    if lead:
        print(f"[dryrun_multichip] ok: {n_dev} ranks ({mesh.backend}, "
              f"{dev}), dp step + ray-sharded + z-sharded (parity "
              f"{zdiff:.2e}) + TILED kernels sharded at 128^2 (parity "
              f"{tdiff:.2e}, {len(sched.groups)} groups, balanced) + tile-DP "
              f"train step + MULTI-VIEW supercell tile-DP fit step (grad "
              f"parity {m_gdiff:.2e}, cell_scale=2 sub-tiled), losses "
              f"{f_losses}, {views_s:.1f} views/s", flush=True)
    return out


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """Run the whole sequence on ``n_devices`` spawned ranks (``device``
    and ``backend`` as :func:`~dvren_tpu_torch.parallel.mesh.launch` takes
    them: ``device="cpu"`` for CPU ranks over gloo; ranks sharing one card
    need ``backend="gloo"``). Returns rank 0's summary; raises when a
    check fails."""
    return launch(_dryrun_rank, n_devices, backend=backend, device=device)
