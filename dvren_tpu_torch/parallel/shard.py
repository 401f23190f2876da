"""Multi-device rendering and training over ranks of a :class:`Mesh`.

Counterpart of ``dvren_tpu/parallel/shard.py``. JAX runs each
decomposition as one ``shard_map`` program over a device mesh; here each
rank runs the body for its device, and every JAX collective becomes one
sum over the rank's process group (:func:`~dvren_tpu_torch.parallel.mesh.
all_reduce_sum`; :class:`~dvren_tpu_torch.parallel.mesh.AllReduceSum`
inside autograd). The decompositions:

1. **Ray data parallelism** (:func:`render_sharded`): each rank renders a
   contiguous 1/D of the frame's rays through the lattice pipeline (the
   port's per-ray integrator, K9f); one sum of zero-filled per-ray heads
   gathers them and every rank composes the frame once.
2. **View data parallelism** (:func:`make_dp_train_step`,
   :func:`fit_dense_grid_dp`): each rank renders its V/D views through
   ``pipeline.render`` (K9f; K9b in the backward); one sum of the
   parameter gradients and the loss, divided by D, is JAX's ``pmean``.
3. **Z-slab sharding** (:func:`render_zsharded`): each rank holds one
   z-slab of the grid plus a halo plane and marches only its slab's step
   window; one sum of the slabs' optical depths (JAX's ``all_gather``, as
   a sum of one-hot rows) gives each rank its direction-ordered prefix,
   and one sum of the (5, N) partials finishes the frame.
4. **Tile sharding through the fused tile kernels**
   (:func:`shard_tiled_schedule`, :func:`render_tiled_sharded`,
   :func:`make_tile_dp_train_step`, :func:`make_tile_dp_multiview_step`,
   :func:`fit_dense_grid_tile_dp`): every tile group's tile axis splits
   into D equal slices, padded with dead tiles as JAX pads them; a rank
   renders its slice of every group as a schedule of its own
   (:func:`rank_schedule`) through the route ``render_tiled`` takes (K3,
   K1; K2, the slot reduction over the rank's gather plan, K4 in the
   backward), places its tiles into a zero tile array, and one sum merges
   the disjoint tiles. The training steps sum the ranks' parameter
   gradients once after ``backward()``.

Every rank computes the same replicated loss from summed values, so
repeat runs at a fixed D are bit-identical and the ranks' parameters stay
equal. Unlike JAX, a rank's gather plan is its own: SPMD needs one program
for every device, so JAX pads the plan classes to their union over the
devices (``_shard_gather_plans``); the port leaves the pads out.

JAX jits the three training steps. Here, on a CUDA mesh over NCCL, each
step is recorded once as a CUDA graph and replayed
(``opt/fit.py::_GraphedStep``), with its all-reduces inside the graph: a
warm-up step creates the communicator and the rank's schedule, the
recording follows, and the parameters and the optimizer's state are put
back, so the first replay is step 1. The optimizer must keep its step
count on the device (the fits build ``Adam(..., capturable=True)`` on
CUDA); a capture that fails raises. On a gloo mesh (CPU ranks, or ranks
sharing one card) gloo sums on the host, which no graph records, so the
steps run their bodies eagerly: the mesh decides this up front
(:func:`record_device`), and ``step.graph`` stays None. The frames
(:func:`render_sharded`, :func:`render_tiled_sharded`,
:func:`render_zsharded`) run eagerly on every mesh: neither package has a
sharded recorded frame (the port records frames only through
``Renderer(enable_graph=True)``).

The stratified jitter is hashed on the rank's device from the rays'
global ids and steps (``ops/rng.py::stratified_jitter``, JAX's hash
inside its jitted program), bit-equal to rows of the plan's host table,
which none of these paths uploads.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dvren_tpu_torch.core.plan import CameraConfig, InterpMode, OobPolicy, Plan
from dvren_tpu_torch.core.status import check
from dvren_tpu_torch.ops.compose import ImagePlanes, compose
from dvren_tpu_torch.ops.gather_plan import build_gather_plan
from dvren_tpu_torch.ops.grid import eval_grid_planes
from dvren_tpu_torch.ops.integrate import OPACITY_EPS, STOP_THRESHOLD
from dvren_tpu_torch.ops.raygen import generate_rays
from dvren_tpu_torch.ops.sampling import generate_samples
from dvren_tpu_torch.opt.fit import (_adam, _GraphedStep, _project,
                                     _scheduled_views, _view_inputs, mse)
from dvren_tpu_torch.parallel.mesh import (AllReduceSum, Mesh,
                                           all_reduce_sum, batch_sharded,
                                           replicated)
from dvren_tpu_torch.render import graph
from dvren_tpu_torch.render import tiled as tiled_mod
from dvren_tpu_torch.render import windowed as windowed_mod
from dvren_tpu_torch.render.pipeline import (eval_fields, integrate_heads,
                                             render)

_DROP_TILE = tiled_mod._DROP_TILE


def _host(a) -> np.ndarray:
    """A schedule array as numpy (tensors are copied from their device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ------------------------------------------------------------ ray and view DP


def ray_shard_lattice(plan: Plan, field, mesh: Mesh):
    """This rank's rays of :func:`render_sharded`: (first ray, ray count,
    sigma, colour, lattice) of rays [r * ceil(N / D), ...) of the plan's
    lattice, or None when the rank holds no ray. The integrator's inputs
    as ``pipeline.render`` builds them, the stratified jitter hashed on
    the device from the rays' global ids (the rows of the plan's table,
    bit for bit)."""
    n = plan.ray_count
    per = -(-n // mesh.size)
    start = min(mesh.rank * per, n)
    count = min(per, n - start)
    if not count:
        return None
    rays = generate_rays(plan, start=start, count=count, device=mesh.device)
    lattice = generate_samples(plan, rays, ray_index_offset=start)
    sigma, color = eval_fields(field, lattice)
    return start, count, sigma, color, lattice


def render_sharded(plan: Plan, field, mesh: Mesh) -> ImagePlanes:
    """One frame with the ray axis split across the mesh: the rank renders
    its contiguous rays (:func:`ray_shard_lattice`) through
    :func:`~dvren_tpu_torch.render.pipeline.render`'s stages, writes their
    heads (radiance, T, opacity, depth) into zero-filled (N, 6) rows, one
    sum gathers the ranks' rows, and every rank composes the frame once
    (composing per rank would add the background D times). Bit-equal to
    ``pipeline.render``: the rays are independent and each head is added
    to zeros. ``field`` lives on the mesh's device."""
    n = plan.ray_count
    shard = ray_shard_lattice(plan, field, mesh)
    if shard is None:
        heads = torch.zeros((n, 6), dtype=torch.float32, device=mesh.device)
    else:
        start, count, sigma, color, lattice = shard
        intl = integrate_heads(sigma, color, lattice, plan.t_near,
                               plan.t_far)
        mine = torch.cat([intl.radiance, intl.transmittance[:, None],
                          intl.opacity[:, None], intl.depth[:, None]], 1)
        heads = torch.cat([mine.new_zeros((start, 6)), mine,
                           mine.new_zeros((n - start - count, 6))])
    heads = AllReduceSum.apply(heads, mesh)
    pixel_ids = generate_rays(plan, device=mesh.device).pixel_ids
    return compose(pixel_ids, heads[:, 0:3], heads[:, 3], heads[:, 4],
                   heads[:, 5], plan.width, plan.height, plan.t_far)


def _parameters(field) -> list:
    return [p for p in field.parameters() if p.requires_grad]


def _on_device(x, mesh: Mesh) -> torch.Tensor:
    """``x`` (numpy, a list or a tensor) as a float32 tensor on the mesh's
    device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device=mesh.device, dtype=torch.float32)


def _sum_grads(mesh: Mesh, params, extra=None, scale: float = 1.0):
    """The parameters' gradients (zeros where a parameter has none) and
    ``extra`` (a 0-d tensor), summed over the ranks in one flat buffer
    and multiplied by ``scale``, in place of each ``.grad``. Returns the
    summed ``extra`` (or None)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = [g.reshape(-1) for g in grads]
    if extra is not None:
        flat.append(extra.detach().reshape(1).to(grads[0].dtype))
    buf = all_reduce_sum(mesh, torch.cat(flat))
    if scale != 1.0:
        buf = buf * scale
    off = 0
    for p, g in zip(params, grads):
        k = g.numel()
        p.grad = buf[off:off + k].view_as(p).clone()
        off += k
    return buf[off] if extra is not None else None


def record_device(mesh: Mesh) -> torch.device | None:
    """Where the mesh's training steps are recorded as CUDA graphs: its
    device when that is CUDA and the group's backend NCCL
    (:func:`graph.available`), else None: gloo sums on the host, which no
    graph records, so the steps run eagerly."""
    return mesh.device if graph.available(mesh.device, mesh.backend) else None


def _mesh_step(mesh: Mesh, field, optimizer, body,
               hold=lambda *_: ()) -> _GraphedStep:
    """``body(*inputs) -> loss``, a step over ``field``'s parameters, as
    the mesh's step: recorded once and replayed on an NCCL CUDA mesh,
    eager elsewhere (:func:`record_device`, decided here). ``hold`` as
    :class:`_GraphedStep` takes it."""
    dev = record_device(mesh)
    params = list(field.parameters())
    return _GraphedStep(body, optimizer, device=lambda *_: dev,
                        params=lambda *_: params, hold=hold)


def make_dp_train_step(plan: Plan, field, optimizer, mesh: Mesh,
                       project=None) -> _GraphedStep:
    """The view-data-parallel step ``step(c2ws (V, 3, 4), targets (V, H,
    W, 3)) -> loss`` on ``field``'s parameters and ``optimizer`` (over
    them): the rank renders its contiguous V/D views
    (:func:`~dvren_tpu_torch.parallel.mesh.batch_sharded`; a
    ``ValueError`` when D does not divide V) through ``pipeline.render``
    at each pose (the plan's k and ortho_scale uploaded once, the jitter
    hashed on the device), takes the mean-square loss over them, and one
    sum over the ranks of the gradients and the loss, divided by D, is
    JAX's ``pmean`` of both; then the optimizer steps and
    ``project(field)`` runs under ``no_grad``. Returns the mean loss (a
    0-d tensor, equal on every rank). Recorded and replayed on an NCCL
    CUDA mesh (keyed on ``c2ws`` and ``targets``: refill them in place
    for new poses), eager on gloo (:func:`record_device`)."""
    params = _parameters(field)
    _, _, k, ortho_scale = _view_inputs(plan, (), mesh.device, table=False)

    def body(c2ws, targets):
        c_loc = batch_sharded(mesh, c2ws)
        t_loc = batch_sharded(mesh, targets)
        optimizer.zero_grad(set_to_none=True)
        pred = torch.stack([render(plan, field, k=k, c2w=c,
                                   ortho_scale=ortho_scale).planes.image
                            for c in c_loc])
        loss = mse(pred, t_loc)
        loss.backward()
        loss = _sum_grads(mesh, params, loss, 1.0 / mesh.size)
        optimizer.step()
        if project is not None:
            with torch.no_grad():
                project(field)
        return loss

    return _mesh_step(mesh, field, optimizer, body)


def _leaf_copy(field, device=None):
    """``field`` with copies of its parameters (on ``device`` when
    named): leaves of their own gradients."""
    return field.with_params(field.sigma.detach().clone().to(device),
                             field.color.detach().clone().to(device))


def _trainable_copy(field, mesh: Mesh):
    """A copy of ``field`` on the mesh's device whose parameters are rank
    0's (:func:`replicated`). Every rank calls it (a broadcast)."""
    trained = _leaf_copy(field, mesh.device)
    with torch.no_grad():
        for p in trained.parameters():
            replicated(mesh, p.data)
    return trained


def _project_field(field) -> None:
    _project(field, 0.0)


def fit_dense_grid_dp(plan: Plan, field, cameras: Sequence[CameraConfig],
                      targets, mesh: Mesh, learning_rate: float = 5e-2,
                      steps: int = 100):
    """The view-data-parallel fit (``dvren_tpu``'s ``fit_dense_grid_dp``):
    Adam with optax's defaults (``opt/fit.py::_adam``: capturable on
    CUDA) over :func:`make_dp_train_step`, recorded and replayed on an
    NCCL CUDA mesh, sigma projected to >= 0 and colour to [0, 1] after
    each step; each step's loss read to the host, as JAX reads it.
    Returns (the fitted field, the (steps,) losses). A ``ValueError``
    when the mesh's size does not divide the view count."""
    if len(cameras) % mesh.size:
        raise ValueError(f"view count {len(cameras)} not divisible by mesh "
                         f"size {mesh.size}")
    trained = _trainable_copy(field, mesh)
    step = make_dp_train_step(plan, trained, _adam(trained, learning_rate),
                              mesh, project=_project_field)
    c2ws = torch.tensor([c.c2w for c in cameras], dtype=torch.float32,
                        device=mesh.device).reshape(-1, 3, 4)
    targets = _on_device(targets, mesh)
    losses = [float(step(c2ws, targets)) for _ in range(steps)]
    return trained, np.asarray(losses)


# ------------------------------------------------------------- z-slab sharding


def build_z_slabs(field, n_devices: int):
    """Host z-slab decomposition of a dense grid with a one-plane halo
    (``dvren_tpu``'s ``build_z_slabs``, numpy, array for array): the Z
    cell range splits into ``n_devices`` runs of ceil(cells / D); slab d
    holds planes [c0_d, hi_c_d], zero-padded to (per + 1) planes. Returns
    (sigma_slabs (D, per+1, ny, nx), color_slabs (D, per+1, ny, nx, 3),
    c0 (D,) int32 first cell, hi_c (D,) int32 one past the last). A slab
    past the last cell is empty (c0 == hi_c == cells: its one plane is
    the top one)."""
    sig = _host(field.sigma)
    col = _host(field.color)
    nz, ny, nx = sig.shape
    cells = nz - 1
    per = -(-cells // n_devices)
    sig_slabs = np.zeros((n_devices, per + 1, ny, nx), sig.dtype)
    col_slabs = np.zeros((n_devices, per + 1, ny, nx, 3), col.dtype)
    c0 = np.minimum(np.arange(n_devices) * per, cells)
    hi_c = np.minimum(c0 + per, cells)
    for d in range(n_devices):
        lo, hi = int(c0[d]), int(hi_c[d])
        n_pl = hi - lo + 1
        sig_slabs[d, :n_pl] = sig[lo:hi + 1]
        col_slabs[d, :n_pl] = col[lo:hi + 1]
    return sig_slabs, col_slabs, c0.astype(np.int32), hi_c.astype(np.int32)


def _slab_windows(plan: Plan, bz0: float, cell_h: float, c0, hi_c):
    """Per (rank, ray) step windows of the slabs' z ranges, widened one
    step each side (a step is skipped only when its whole [base_t, base_t
    + dt) range provably misses the slab): (k_enter (D, N) int32, the
    step budget, a multiple of 8 covering every window, at most
    max_steps). ``dvren_tpu``'s host intersection, in float64."""
    o_h, d_h = windowed_mod._host_rays(plan)
    n_dev = len(c0)
    n = plan.ray_count
    dt_f = float(plan.sampling.dt)
    k_cap = int(plan.sampling.max_steps)
    ke_np = np.zeros((n_dev, n), np.int64)
    cnt_np = np.zeros((n_dev, n), np.int64)
    dz = d_h[:, 2]
    oz = o_h[:, 2]
    for d in range(n_dev):
        lo_z = bz0 + float(c0[d]) * cell_h
        hi_z = bz0 + float(hi_c[d]) * cell_h
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (lo_z - oz) / dz
            t1 = (hi_z - oz) / dz
        t_lo = np.minimum(t0, t1)
        t_hi = np.maximum(t0, t1)
        para = np.abs(dz) < 1e-12
        inside = (oz >= lo_z) & (oz <= hi_z)
        t_lo = np.where(para, np.where(inside, plan.t_near, plan.t_far), t_lo)
        t_hi = np.where(para, np.where(inside, plan.t_far, plan.t_near), t_hi)
        t_lo = np.maximum(t_lo, plan.t_near)
        t_hi = np.minimum(t_hi, plan.t_far)
        k_lo = np.clip(np.floor((t_lo - plan.t_near) / dt_f) - 1, 0, k_cap)
        k_hi = np.clip(np.ceil((t_hi - plan.t_near) / dt_f) + 1, 0, k_cap)
        ke_np[d] = k_lo.astype(np.int64)
        cnt_np[d] = np.maximum(k_hi - k_lo, 0).astype(np.int64)
    budget = int(min(max(-(-int(cnt_np.max()) // 8) * 8, 8), k_cap))
    return ke_np.astype(np.int32), budget


def render_zsharded(plan: Plan, field, mesh: Mesh, jitter=None
                    ) -> ImagePlanes:
    """A frame with the field split in z across the mesh: the rank holds
    its z-slab and one halo plane (:func:`build_z_slabs`) and marches only
    its slab's step window of every ray (the window budget is the mesh's
    largest). The emission-absorption integral decomposes over slabs: a
    ray crosses them in z order, so the transmittance before rank d's
    samples is exp(-carry_d), carry_d the optical depth of the slabs it
    crossed before (below d when the ray rises in z, above when it
    falls). Two sums: each rank's slab optical depths as its row of a
    (D, N) zero array (JAX's ``all_gather``; adding zeros is exact), then
    the (5, N) weighted partials. Early termination (T <= 1e-4) is exact
    through the global prefix. Plain torch ops (JAX runs no Pallas kernel
    here) and the jitter kernel; OOB_ZERO trilinear dense grids only.
    ``jitter``: an (N, K) stratified table whose columns the windows
    gather; by default the jitter of each window's global steps is hashed
    on the device (the plan's table, bit for bit). A sample on a cut
    plane belongs to the upper slab, one on the grid's top plane to the
    last rank. Within float32 roundoff of ``pipeline.render``. Forward only:
    the slabs are host copies of the field, so no gradient could reach
    it; with gradients enabled on a field whose parameters require them
    it raises :class:`DvrenError` (call it under ``torch.no_grad()``)."""
    check(not (torch.is_grad_enabled()
               and any(p.requires_grad for p in field.parameters())),
          "render_zsharded is forward-only: call it under torch.no_grad() "
          "or on a field that requires no gradient")
    check(getattr(field, "oob", None) == OobPolicy.ZERO,
          "z-sharded rendering requires an OOB_ZERO dense grid")
    check(getattr(field, "interp", None) == InterpMode.LINEAR,
          "z-sharded rendering requires trilinear interpolation")
    n_dev, d_idx, dev = mesh.size, mesh.rank, mesh.device
    sig_slabs, col_slabs, c0, hi_c = build_z_slabs(field, n_dev)
    per = sig_slabs.shape[1] - 1
    nz = int(field.sigma.shape[0])
    bz0 = float(field.bbox_min[2])
    cell_h = (float(field.bbox_max[2]) - bz0) / float(nz - 1)
    ke_np, budget = _slab_windows(plan, bz0, cell_h, c0, hi_c)
    f32 = np.float32
    lo_z = f32(bz0) + f32(c0[d_idx]) * f32(cell_h)
    hi_real = f32(bz0) + f32(hi_c[d_idx]) * f32(cell_h)
    is_last = d_idx == n_dev - 1

    sig = torch.from_numpy(sig_slabs[d_idx]).to(dev)
    col = torch.from_numpy(col_slabs[d_idx]).to(dev)
    ke = torch.from_numpy(ke_np[d_idx]).to(dev)
    rays = generate_rays(plan, device=dev)
    block_jitter = None
    if jitter is not None:
        tab = _on_device(jitter, mesh)
        cols = torch.clamp(ke[:, None].long()
                           + torch.arange(budget, device=dev)[None, :],
                           0, tab.shape[1] - 1)
        block_jitter = torch.gather(tab, 1, cols)
    lattice = generate_samples(plan, rays, jitter=block_jitter,
                               step_offset=ke, num_steps=budget)
    pz = lattice.pz
    # the slab's frame: z in [0, 1] over its per * cell_h extent
    pz_loc = (pz - float(lo_z)) * float(f32(1.0 / (float(per) * cell_h)))
    bb_min = (field.bbox_min[0], field.bbox_min[1], 0.0)
    bb_max = (field.bbox_max[0], field.bbox_max[1], 1.0)
    sigma = eval_grid_planes(sig, lattice.px, lattice.py, pz_loc, bb_min,
                             bb_max, field.interp, field.oob)
    cr, cg, cb = eval_grid_planes(col, lattice.px, lattice.py, pz_loc,
                                  bb_min, bb_max, field.interp, field.oob)
    in_slab = (pz >= float(lo_z)) & (pz <= float(hi_real) if is_last
                                     else pz < float(hi_real))
    live = lattice.mask & in_slab
    od = torch.clamp_min(sigma * lattice.dt, 0.0) * live.to(torch.float32)

    # the slabs' optical depths -> the prefix of the slabs crossed before
    n = plan.ray_count
    taus = torch.zeros((n_dev, n), dtype=torch.float32, device=dev)
    taus[d_idx] = od.sum(dim=1)
    taus = all_reduce_sum(mesh, taus)
    order = torch.arange(n_dev, device=dev)[:, None]
    before = torch.where((rays.directions[:, 2] >= 0.0)[None, :],
                         order < d_idx, order > d_idx)
    carry = (taus * before.to(torch.float32)).sum(dim=0)

    cum = carry[:, None] + torch.cumsum(od, dim=1)
    p = torch.exp(-cum)
    tb = torch.exp(-(cum - od))
    procf = (live & (tb > STOP_THRESHOLD)).to(torch.float32)
    w = (tb - p) * procf
    # the depth cursor: the window's origin (steps before it are never
    # t_far-truncated) plus the in-window dt prefix
    dt_m = lattice.dt * lattice.mask.to(torch.float32)
    t_origin = (float(f32(plan.t_near))
                + ke.to(torch.float32) * float(f32(plan.sampling.dt)))
    t_cursor = t_origin[:, None] + torch.cumsum(dt_m, dim=1) - dt_m
    mid = t_cursor + 0.5 * lattice.dt
    parts = torch.stack([(w * cr).sum(1), (w * cg).sum(1), (w * cb).sum(1),
                         (w * mid).sum(1), (od * procf).sum(1)])
    parts = all_reduce_sum(mesh, parts.contiguous())
    t_final = torch.exp(-parts[4])
    opacity = 1.0 - t_final
    depth = torch.where(opacity > OPACITY_EPS,
                        parts[3] / torch.clamp_min(opacity, OPACITY_EPS),
                        torch.full_like(opacity, float(plan.t_far)))
    return compose(rays.pixel_ids, parts[0:3].t(), t_final, opacity, depth,
                   plan.width, plan.height, plan.t_far)


# ------------------------------------------------------------- tile sharding


def shard_tiled_schedule(schedule, n_dev: int,
                         global_tile_ids=None) -> list:
    """Every tile group's tile axis split into ``n_dev`` equal slices
    (``dvren_tpu``'s ``shard_tiled_schedule``, array for array): a group
    of T tiles pads to ceil(T / 8D) * 8D with dead tiles (zero arrays,
    hostmap -1, tile id 1 << 30, which the compose drops), so each slice
    holds a multiple of the kernels' 8-tile block. Returns per group a
    dict of numpy arrays with a leading rank axis: samp, base, rayt,
    bank0, k_enter, hostmap (D, T / D, banks * 128) and tile_ids.
    ``global_tile_ids``: per group (T, n_sub) compose ids replacing the
    group's (:func:`merged_global_tile_ids`). The schedule's arrays may be
    numpy or tensors. The windowed fallback is not sharded: callers check
    ``schedule.fallback_rays == 0``. JAX also carries union-padded gather
    plans here; each rank's own plan comes with :func:`rank_schedule`."""
    groups = []
    for gi, g in enumerate(schedule.groups):
        t = g.n_tiles
        tp = -(-t // (n_dev * 8)) * (n_dev * 8)

        def pad(a, fill=0):
            a = _host(a)
            if tp != t:
                a = np.concatenate(
                    [a, np.full((tp - t,) + a.shape[1:], fill, a.dtype)])
            return a.reshape((n_dev, tp // n_dev) + a.shape[1:])

        tile_ids = (g.tile_ids if global_tile_ids is None
                    else global_tile_ids[gi])
        groups.append(dict(
            samp=pad(g.samp), base=pad(g.base), rayt=pad(g.rayt),
            bank0=pad(g.bank0), k_enter=pad(g.k_enter),
            hostmap=pad(_host(g.hostmap).reshape(t, -1), fill=-1),
            tile_ids=pad(tile_ids, fill=_DROP_TILE)))
    return groups


def live_tiles_per_rank(group_shards: dict) -> np.ndarray:
    """(D,) the tiles with a live sub-tile in each rank's slice of one
    group (:func:`shard_tiled_schedule`'s dict)."""
    ids = group_shards["tile_ids"]
    live = ids.reshape(ids.shape[0], ids.shape[1], -1) < _DROP_TILE
    return live.any(axis=2).sum(axis=1)


def rank_schedule(schedule, shards: list, rank: int):
    """Rank ``rank``'s slice of every group (``shards`` from
    :func:`shard_tiled_schedule`) as a pitch-1 numpy
    :class:`~dvren_tpu_torch.render.tiled.TiledSchedule` whose gathermap
    is its hostmap: what JAX's sharded body gathers (a pitch-2 schedule's
    hostmap names each lane's row). It carries its tile set and the gather
    plan of its concatenated hostmap, whose classes hold only this rank's
    cells: JAX's per-device plan without its union padding, equal to it
    with the pad entries left out. A rank of dead tiles only has no plan
    (None) and renders zeros."""
    groups, hm_parts, samples = [], [], 0
    for g, sh in zip(schedule.groups, shards):
        t_loc = int(sh["samp"].shape[1])
        lo = rank * t_loc
        tp = t_loc * int(sh["samp"].shape[0])

        def rows(a, fill):
            a = _host(a).reshape(g.n_tiles, -1)
            a = np.concatenate(
                [a, np.full((tp - g.n_tiles, a.shape[1]), fill, a.dtype)])
            return a[lo:lo + t_loc]

        hostmap = np.ascontiguousarray(sh["hostmap"][rank]).reshape(-1)
        samp = sh["samp"][rank]
        live = int(((samp[:, :, 2] >> 15) & 1).sum())
        samples += live
        hm_parts.append(hostmap)
        groups.append(tiled_mod.TileGroup(
            n_chunks=g.n_chunks, n_tiles=t_loc, banks=g.banks,
            hostmap=hostmap, gathermap=hostmap, samp=samp,
            base=sh["base"][rank], rayt=sh["rayt"][rank],
            bank0=sh["bank0"][rank],
            ray_ids=rows(g.ray_ids, 0).reshape(t_loc, -1),
            k_enter=sh["k_enter"][rank],
            pixel_ids=rows(g.pixel_ids, _DROP_TILE).reshape(-1),
            tile_ids=sh["tile_ids"][rank], samples=live))
    hostmap_all = (np.concatenate(hm_parts) if hm_parts
                   else np.zeros(0, np.int32))
    plan = None
    if schedule.gather_plan is not None:
        plan = build_gather_plan(
            hostmap_all, int(schedule.gather_plan.inv_map.shape[0]))
    n_rays = sum(g.n_tiles for g in groups) * tiled_mod.RAYS_PER_TILE
    return tiled_mod.TiledSchedule(
        groups=tuple(groups), fallback=None, hostmap_all=hostmap_all,
        gathermap_all=hostmap_all, gather_plan=plan, total_rays=n_rays,
        tiled_samples=samples, full_lattice_samples=0, fallback_rays=0,
        grid_shape=tuple(schedule.grid_shape),
        bbox=tuple(tuple(b) for b in schedule.bbox),
        tile_px=schedule.tile_px, table_kind=schedule.table_kind, pitch=1,
        cell_scale=schedule.cell_scale).with_tiles()


# (schedule, shards, rank, size, device, rank schedule): the rank
# schedules built last, newest last. Holding the schedule and shards
# objects keeps their ids from being reused while they are keys.
_RANK_TILES: list = []
_RANK_TILES_KEPT = 4


def _rank_tiles(schedule, shards, mesh: Mesh):
    """This rank's schedule on its device (:func:`rank_schedule` of
    :func:`shard_tiled_schedule`'s arrays ``shards``, or of ``schedule``'s
    own slices when ``shards`` is None), built on the host and uploaded
    once: every sharded tile path asks here, and the last few built are
    reused while the same schedule and shards objects come back (they are
    read, never edited in place)."""
    key = (mesh.rank, mesh.size, mesh.device)
    for entry in _RANK_TILES:
        if entry[0] is schedule and entry[1] is shards and entry[2] == key:
            return entry[3]
    slices = (shards if shards is not None
              else shard_tiled_schedule(schedule, mesh.size))
    built = rank_schedule(schedule, slices, mesh.rank).to(mesh.device)
    _RANK_TILES.append((schedule, shards, key, built))
    del _RANK_TILES[:-_RANK_TILES_KEPT]
    return built


def _sharded_tiles5(plan: Plan, field, rank_sched, mesh: Mesh,
                    n_views: int = 1) -> torch.Tensor:
    """Every tile's heads (V * n_tiles, 5, px, px) in ROI tile order: the
    rank's tiles rendered through ``render_tiled``'s route
    (``tiled._tiles_raw``), placed at their ids in a zero array
    (``_PlaceTiles``; pad tiles dropped), and one differentiable sum over
    the ranks, whose tiles are disjoint."""
    roi = plan.roi
    px = rank_sched.tile_px
    n_tiles = n_views * (-(-roi.width // px)) * (-(-roi.height // px))
    tiled_mod._check_field_schedule(field, rank_sched, "the rank schedule")
    raw = tiled_mod._tiles_raw(plan, field, rank_sched, True)
    if raw is None:
        tiles5 = torch.zeros((n_tiles, 5, px, px), dtype=torch.float32,
                             device=mesh.device)
    else:
        ids = torch.cat([g.tile_ids.reshape(-1)
                         for g in rank_sched.groups]).long()
        tiles5 = tiled_mod._PlaceTiles.apply(
            tiled_mod.raw_to_subtiles(raw, px), ids, n_tiles)
    return AllReduceSum.apply(tiles5, mesh)


def _planes(plan: Plan, tiles5: torch.Tensor, tile_px: int) -> ImagePlanes:
    image, trans, opac, dep = tiled_mod.tiles5_to_planes(plan, tiles5,
                                                         tile_px)
    return ImagePlanes(image=image, transmittance=trans, opacity=opac,
                       depth=dep,
                       hitmask=windowed_mod.roi_hitmask(plan, image.device))


def _stack(plan: Plan, tiles5: torch.Tensor, tile_px: int,
           n_views: int) -> torch.Tensor:
    tv = tiles5.reshape((n_views, -1) + tuple(tiles5.shape[1:]))
    return torch.stack([tiled_mod.tiles5_to_planes(plan, tv[v], tile_px)[0]
                        for v in range(n_views)])


def render_tiled_sharded(plan: Plan, field, schedule, mesh: Mesh,
                         shards=None) -> ImagePlanes:
    """One frame through the fused tile kernels with the tile axis split
    across the mesh (``dvren_tpu``'s ``render_tiled_sharded``): the rank
    renders its slice of every group through the route ``render_tiled``
    takes for ``field`` (K3 and K1 for a dense float32 grid, the
    supercell table, K5a for a 16-bit table, the bricks of a sparse
    field), places its tiles, and one sum over the ranks merges the
    frame. Bit-equal to ``render_tiled`` on the same schedule: tiles are
    independent and each is added to zeros. Differentiable in the field
    (the rank's gradient covers its tiles; sum the ranks' gradients, as
    :func:`make_tile_dp_train_step` does); camera gradients are not
    carried. ``shards``: :func:`shard_tiled_schedule`'s arrays (default:
    the schedule's own); the rank's schedule is built from them once
    (:func:`_rank_tiles`). The schedule must have no fallback rays."""
    check(schedule.fallback_rays == 0,
          "sharded tiled rendering requires a fallback-free schedule")
    rs = _rank_tiles(schedule, shards, mesh)
    return _planes(plan, _sharded_tiles5(plan, field, rs, mesh),
                   rs.tile_px)


def _tile_step(mesh: Mesh, field, optimizer, project, schedule,
               render_fn) -> _GraphedStep:
    """``step(shards, target) -> loss``: the rank's schedule of
    ``schedule`` sliced as ``shards`` (:func:`_rank_tiles`), ``render_fn(
    rank schedule)`` -> prediction, the mean-square loss, backward, one
    sum of the ranks' parameter gradients, the optimizer's step and
    ``project(field)`` under ``no_grad``; recorded and replayed on an NCCL
    CUDA mesh (keyed on the ``shards`` object, the target and the rank
    schedule, which the recording holds: the cache may drop it), eager on
    gloo (:func:`record_device`)."""
    params = _parameters(field)

    def body(shards, target):
        optimizer.zero_grad(set_to_none=True)
        loss = mse(render_fn(_rank_tiles(schedule, shards, mesh)), target)
        loss.backward()
        _sum_grads(mesh, params)
        optimizer.step()
        if project is not None:
            with torch.no_grad():
                project(field)
        return loss.detach()

    return _mesh_step(mesh, field, optimizer, body, hold=lambda shards, _: (
        _rank_tiles(schedule, shards, mesh),))


def make_tile_dp_train_step(plan: Plan, field, optimizer, mesh: Mesh,
                            schedule, project=None):
    """The tile-data-parallel step through the fused tile kernels
    (``dvren_tpu``'s ``make_tile_dp_train_step``): ``step(shards, target
    (H, W, 3)) -> loss`` on ``field``'s parameters and ``optimizer``. The
    rank renders its tiles of ``schedule`` (:func:`render_tiled_sharded`),
    the loss is the mean square against the replicated target, the
    backward runs K2, the slot reduction over the rank's gather plan and
    K4 on the rank's tiles, one sum over the ranks gives the parameter
    gradients, then the optimizer steps and ``project(field)`` runs under
    ``no_grad``. One schedule per step (``shards`` None: its own
    slices). On an NCCL CUDA mesh the step is recorded once and replayed
    (:func:`_tile_step`)."""
    check(schedule.fallback_rays == 0,
          "sharded tiled rendering requires a fallback-free schedule")

    def render_fn(rs):
        return _planes(plan, _sharded_tiles5(plan, field, rs, mesh),
                       rs.tile_px).image

    return _tile_step(mesh, field, optimizer, project, schedule, render_fn)


def merged_global_tile_ids(plan: Plan, merged) -> list:
    """Per merged group its global compose ids ``view * n_tiles + tile``
    (the drop id kept), so every view's tiles place into one (V *
    n_tiles, ...) array (``dvren_tpu``'s ``merged_global_tile_ids``)."""
    roi = plan.roi
    px = merged.sched.tile_px
    nt = (-(-roi.width // px)) * (-(-roi.height // px))
    out = []
    for gi, g in enumerate(merged.sched.groups):
        ids = _host(g.tile_ids)
        view = np.zeros(ids.shape[0], np.int32)
        for (v, t0, cnt) in merged.view_slices[gi]:
            view[t0:t0 + cnt] = v
        out.append(np.where(ids >= _DROP_TILE, ids,
                            view[:, None] * nt + ids).astype(np.int32))
    return out


def make_tile_dp_multiview_step(plan: Plan, field, optimizer, mesh: Mesh,
                                merged, project=None):
    """The multi-view tile-data-parallel step (``dvren_tpu``'s
    ``make_tile_dp_multiview_step``): the merged view schedule's tile axis
    split across the mesh with global tile ids, every rank renders its
    slice of every view, one sum merges the (V, H, W, 3) stack, and the
    step runs as :func:`make_tile_dp_train_step`'s. Returns (step,
    shards) with ``step(shards, targets (V, H, W, 3)) -> loss``.
    Supercell schedules (the fit flagship's 8 px supercells: K1 / K2 at
    subs 4) are supported; fallback rays are not."""
    sched = merged.sched
    check(sched.fallback_rays == 0
          and all(f is None for f in merged.view_fallbacks),
          "multi-view tile-DP requires fallback-free merged schedules")
    shards = shard_tiled_schedule(
        sched, mesh.size, global_tile_ids=merged_global_tile_ids(plan, merged))

    def render_fn(rs):
        tiles5 = _sharded_tiles5(plan, field, rs, mesh, merged.n_views)
        return _stack(plan, tiles5, rs.tile_px, merged.n_views)

    return (_tile_step(mesh, field, optimizer, project, sched, render_fn),
            shards)


def fit_dense_grid_tile_dp(plan: Plan, field,
                           cameras: Sequence[CameraConfig], targets,
                           mesh: Mesh, learning_rate: float = 5e-2,
                           steps: int = 100):
    """The multi-device fit through the fused tile kernels
    (``dvren_tpu``'s ``fit_dense_grid_tile_dp``): the single-card fit's
    merged multi-view schedule (``opt/fit.py::_scheduled_views``) with the
    tile axis split across the mesh (:func:`make_tile_dp_multiview_step`,
    recorded and replayed on an NCCL CUDA mesh), Adam with optax's
    defaults (``opt/fit.py::_adam``: capturable on CUDA), sigma projected
    to >= 0 and colour to [0, 1]; each step's loss read to the host, as
    JAX reads it. When the schedules carry fallback rays it runs
    :func:`fit_dense_grid_dp` instead, as JAX's does. Returns (the fitted
    field, the (steps,) losses)."""
    trained = _trainable_copy(field, mesh)
    _, merged, _ = _scheduled_views(plan, cameras, trained, "tiled")
    if (merged.sched.fallback_rays
            or any(f is not None for f in merged.view_fallbacks)):
        return fit_dense_grid_dp(plan, field, cameras, targets, mesh,
                                 learning_rate=learning_rate, steps=steps)
    step, shards = make_tile_dp_multiview_step(
        plan, trained, _adam(trained, learning_rate), mesh, merged,
        project=_project_field)
    targets = _on_device(targets, mesh)
    losses = [float(step(shards, targets)) for _ in range(steps)]
    return trained, np.asarray(losses)
