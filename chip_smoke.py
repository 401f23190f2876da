#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--only dense|grid]

Drives the port's main paths once each, at the headline configurations:
the dense-grid tiled render at 512^2 rays over a 64^3 Gaussian-blob grid
with 128 stratified steps (seed 3; the scene ``bench.py::_scene`` builds,
rebuilt here in numpy) through ``Renderer.forward``, its gradients
through ``Renderer.backward``, and a few SGD training steps through
autograd of ``render_tiled``; the same grid with bfloat16 and float16
packed tables and as sparse bricks (float32 and bfloat16); then the
hash-MLP field (the L=8, T=128
spec of ``tools/hashmlp_bench.py``) rendered at 512^2 with 128
stratified steps (seed 5) through ``Renderer.forward`` and fitted with
``fit_hash_mlp`` (4 views at 96^2, 64 steps, Adam lr 8e-3); then the
NGP-scale hash grid path (``tools/hashmlp_bench.py``'s grid spec: L=4,
F=2, T=4096, resolutions 4-8-16-32) at 512^2 with 128 stratified steps
(seed 5) through ``render_hash_grid_tiled`` and 10 Adam steps through its
autograd; then the sub-tiled and supercell schedules of the cascade:
``tools/finegrid_bench.py``'s fine-grid scene (512^2 over a 128^3 blob,
256 stratified steps, seed 3) in float32 and bfloat16, and the eight
views of ``tools/fit_benchmark.py``'s fit flagship (96^2 over 64^3, 96
steps); then the grid path over those eight views (the grid spec at
finest 32 and at finest 64, the cascade's 8 and 4 px sub-tiles), and
``fit_dense_grid`` at the flagship on the views' merged schedule. Phases,
each fatal when it fails:

1. print the card's name and power limit; build the CUDA kernels from
   ``dvren_tpu_torch/csrc`` and print the build time;
2. K3 (packed-table build) against its plain twin at 64^3: bit-exact;
3. build the headline schedule (no overflow rays allowed);
4. K1 (fused tile forward) against its plain twin on every tile group:
   within 5e-6 after ``finalize_heads`` (depth 1e-4);
5. ``Renderer(Context.create(device="cuda"), plan).forward(field)``: the
   kernels' launch counts rise, the planes are finite with opacity > 0
   somewhere and match the plain path on the card; the small test scene
   rendered on the card matches the plain path on the CPU;
6. times, with CUDA events, after warm-up: the forward per frame (the
   schedule excluded) and its stages, and each kernel beside its plain
   twin;
7. K2 (fused tile backward) against its plain twin on every tile group,
   with and without the camera adjoint, for a seeded random cotangent:
   d(table) within 2e-6 x scale, d(rayt) within 1e-5 x scale, and two
   runs equal bit for bit;
8. K4 (table-gradient unpack) against its plain twin at 64^3: bit-exact;
9. ``Renderer.backward`` under ``torch.use_deterministic_algorithms``:
   finite, nonzero grid and camera gradients, within tolerance of the
   plain path on the card, two calls equal bit for bit; the small test
   scene's backward on the card matches the CPU's;
10. four SGD steps (MSE against a zero target, as ``bench.py`` trains)
    through autograd of ``render_tiled``, at bench's lr 1e-3 and at that
    lr times the image's 512*512*3 values (at 1e-3 the updates are below
    float32 resolution): the loss is finite and falls at the scaled lr,
    K1-K4 each launch in every step; then the step time (forward,
    backward, update) at lr 1e-3 over 10 steps with CUDA events, its
    stages beside their plain twins, and peak device memory;
11. K7f (fused hash-MLP forward) against its plain twin at the hash
    headline, the field from a seeded ``torch.Generator``: within 5e-6
    after ``finalize_heads`` (depth 1e-4); the hash schedule's build and
    upload times;
12. ``Renderer(Context.create(device="cuda"), plan).forward(hash_field)``:
    the K7f launch count rises, the planes are finite with opacity > 0
    somewhere and match the plain path on the card; the small hash test
    scene (24x20) rendered on the card matches the CPU twin;
13. K7b (fused hash-MLP backward) against its plain twin for a seeded
    random cotangent on a subset of the headline's tiles: d(table) and
    d(MLP) within 2e-5 x scale; two runs on the full frame equal bit for
    bit;
14. ``fit_hash_mlp`` for 25 Adam steps (``sync_every=25``) toward a
    teacher field of the same spec rendered by the port from the same
    cameras: the loss is finite and falls, K7f and K7b launch in every
    step, ``steady_step_ms`` > 0; then K7f and K7b against their twins at
    the fit's shapes (its four-view stack schedule, a seeded random
    cotangent), for the fitted student and for the teacher made opaque
    (sigma_b2 + 5), on which some rays must stop early: K7f within 5e-6
    after ``finalize_heads`` (depth 1e-4), K7b within 2e-5 x scale;
15. times with CUDA events after warm-up, each beside its plain twin's:
    the hash forward per frame and Mrays/s (schedule excluded), K7f, K7b,
    the fit step (forward, backward, Adam), and the peak device memory
    each adds to what the earlier phases hold;
16. the grid headline schedule (16 px tiles, 0 overflow rays, 8 groups;
    its build and upload times) and K8f (fused hash-grid forward) against
    its plain twin on every group: within 5e-6 after ``finalize_heads``
    (depth 1e-4);
17. ``render_hash_grid_tiled`` on the card against the plain path on the
    card: the K8f launch count rises by one per group, the planes are
    finite with opacity > 0 somewhere; the small grid test scene
    (tests/test_hash_grid.py's 32^2 / 16 steps, L=3 / T=4096) on the card
    matches the CPU twin;
18. K8b (fused hash-grid backward) against its plain twin for a seeded
    random cotangent on a subset of the headline's tiles: slot rows and
    d(MLP) within 2e-5 x scale; under
    ``torch.use_deterministic_algorithms`` two full-frame backwards
    through autograd equal bit for bit, d(hash_table) included;
19. 10 Adam steps (lr 8e-3) through autograd of ``render_hash_grid_tiled``
    toward a teacher of the same spec (``torch.Generator`` seed 2, table
    std 1.0) rendered by the port: the loss is finite and falls, K8f and
    K8b launch in every step;
20. times with CUDA events after warm-up, each beside its plain twin's
    where there is one: the grid forward per frame and Mrays/s (schedule
    excluded), the table build, the bank gather, K8f, K8b, the slot
    reduction, the table adjoint, the training step, and the peak device
    memory each adds;
21. K5a (16-bit packed-table build) against its plain twin at 64^3, for
    bfloat16 and float16: bit-exact;
22. ``Renderer.forward`` on the headline field with
    ``packed_dtype="bfloat16"`` and ``"float16"`` (the schedule, keyed by
    the dtype, rebuilt: the headline's 16 px cells): K5a launches once
    and K3 not, K1 once per group;
    the planes match the plain path on the card within 5e-6 (depth 1e-4)
    and the float32 frame within 5e-3;
23. K5b (16-bit table-gradient unpack) against its plain twin on the
    headline's table gradient (phase 7's K2 rows through the 16-bit
    reduction): bit-exact;
24. ``Renderer.backward`` on both 16-bit fields under
    ``torch.use_deterministic_algorithms``: K2 per group, K5a and K5b
    once; finite, nonzero, two calls equal bit for bit, within c * ulp x
    scale of the plain path (c the largest slot class);
25. four SGD steps on the bfloat16 field at lr 1e-3 x 512*512*3: K1, K2,
    K5a and K5b launch every step, K3 and K4 never; the loss falls;
26. ``SparseGridField.from_dense(headline, threshold=0)`` in float32 and
    bfloat16 (all 512 bricks kept) through ``Renderer.forward``: K1 alone,
    the frame equal to the dense frame of the same type; ``.backward``
    deterministic and repeat-equal, within 2e-6 (float32) or c * ulp x
    scale (bfloat16) of the plain path; four SGD steps on the float32
    bricks (K1 and K2 alone; the loss falls);
27. times with CUDA events: the 16-bit and sparse frames and steps beside
    their plain paths, K5a and K5b beside their twins and the one
    PyTorch call that computes the TPU kernel's function (a transpose:
    ``stack.t().contiguous()`` of the (32, R) 16-bit stack,
    ``rows.t().contiguous()`` of the (R, 32) float32 rows), and the peak
    device memory each adds;
28. the fine-grid scene through ``Renderer.forward``'s cascade (16 px
    supercells, 0 overflow rays): K1 once per group and no table kernel;
    the frame against the plain path on the card; the schedule's form,
    groups, banks, live samples and build time;
29. K1 and K2 in that form against their twins on the first 8 tiles of
    every group: bit for bit, repeats too; two deterministic
    ``Renderer.backward`` calls equal; four SGD steps at lr 1e-3 x
    786,432 (the loss falls, K2 per group each step); the frame, the step,
    K1 and K2 beside their twins (CUDA events; the twins once);
30. the same with ``packed_dtype="bfloat16"`` (8 px cells, K5a once);
31. the fit flagship's eight views, each through the cascade (8 px
    supercells): K1 and K2 against their twins on every group, bit for
    bit;
32. 10 Adam steps (lr 5e-2, the flagship's) from a flat student on the
    summed loss of the eight views (the loss falls); view 0's grid and
    camera gradients against the plain path, two runs equal; times;
33. view 0 at 4 px (0 overflow rays): frame and backward against the
    plain path, the frame equal to the 8 px supercell frame bit for bit,
    two deterministic backwards equal, K1 and K2 against their twins on
    every group, times;
34. the grid spec of ``tools/hashmlp_bench.py`` (finest 32) over the
    flagship's eight 96^2 views, each through ``build_hash_grid_schedule``'s
    cascade (8 px, 0 overflow rays; groups, banks and build times
    printed): K8f at subs 4 equal to its twin bit for bit on every group,
    K8b within 2e-5 x scale on every tile and repeat-equal (each twin run
    once, timed); view 0's ``render_hash_grid_tiled`` against the plain
    path; 10 Adam steps (lr 8e-3) on the summed loss of the views toward a
    teacher (``torch.Generator`` seed 2, table std 1.0): the loss falls,
    K8f and K8b launch once per group in every step; times with CUDA
    events;
35. the same at finest 64 (resolutions 8-16-32-64): 4 px, K8 at subs 16,
    at most 77 banks per tile (the gathered tables' size printed first);
36. ``fit_dense_grid`` at the fit flagship (``tools/fit_benchmark.py``'s
    scene and cameras, Adam lr 5e-2, target PSNR 35, ``sync_every=32``,
    at most 300 steps), toward phase 31's per-view frames: the auto mode
    keeps "tiled", the views merge into one 8 px supercell group (its
    shape printed), the stack equals the per-view frames within 5e-6, K1
    and K2 equal their twins on the group's first 8 tiles and launch once
    per step each; the steps to PSNR 35, ``schedule_build_s``,
    ``first_step_s``, ``steady_step_ms``, ``wall_clock_s``, and the Adam
    step with CUDA events beside phase 32's (each view its own schedule).

``--only dense`` runs phases 1-10, ``--only grid`` phases 1 and 16-20:
each alone, to time two trees against each other in one call.

Prints a JSON line of per-kernel results (each with its bound: the larger
of the bytes its inputs and outputs take over the H100's 3.35 TB/s and
its float operations over 67 TFLOP/s, the H100 SXM's published
peaks; ``library_ms`` is null where no single PyTorch call computes the
function, the transpose's time for K5a and K5b), then the card line, and
as the last line
``{"ok": true, "device": {...}}``. Exits nonzero, without that
line, when CUDA is missing, a kernel does not build, or any check fails.
Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
import traceback

import numpy as np

TOL = 5e-6          # radiance, transmittance, opacity
TOL_DEPTH = 1e-4    # depth is a ratio: wd / opacity
GRID_TOL = 2e-6     # gradients and d(table), x max |reference|
HASH_GRAD_TOL = 2e-5  # K7b, x max |reference| (tests/test_hash_tiled.py)
HASH_SUBSET = 64    # headline tiles the K7b twin is compared on
FIT_STEPS = 25
OPAQUE_BIAS = 5.0   # added to the teacher's sigma_b2: rays stop early
GRID_SUBSET = 8     # tiles per group the K8b twin is compared on
GRID_STEPS = 10     # Adam steps on the grid path
GRID_GROUPS = 8     # tile groups of the grid headline's schedule
GRID_OPAQUE_BIAS = 30.0   # added to the grid teacher's sigma_b2 (5 stops no ray)
# tools/hashmlp_bench.py's grid spec (:133-143)
GRID_SPEC = dict(n_levels=4, features_per_level=2, table_size=4096,
                 hidden_dim=8, base_resolution=4.0, finest_resolution=32.0,
                 resolutions=(4, 8, 16, 32))
RAYT_TOL = 1e-5     # d(rayt), x max |reference|
CAM_RTOL, CAM_ATOL = 2e-3, 1e-4   # camera gradients
FRAMES = 30         # timed forward frames
STEPS = 10          # timed training steps
LR = 1e-3           # bench.py's SGD step


# The H100 SXM's published peaks: HBM bytes
# per second and float32 operations per second outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# Float operations per processed sample that each function needs from its
# inputs (exp as one; integer and comparison work not counted), counted
# from each kernel's source but without the work a kernel's own design
# adds: a backward counts the forward once (not pass 1's recompute), the
# adjoint, and a product and an add per slot-row column (not the weights
# its window sums recompute). The dense stencil forward: fractions 18,
# corner weights 19, 4 x 8 corners 64, recurrence 15. Its adjoint without
# the camera term, as timed: the forward, then the step times, the
# transmittance and plane adjoint and 32 slot products (105). The
# recurrence; the adjoint's transmittance part.
DENSE_FWD_OPS = 116
DENSE_BWD_OPS = DENSE_FWD_OPS + 105
RECUR_OPS = 15
ADJ_OPS = 20


def enc_ops_hash(spec) -> int:
    """K7's per-sample encoding: per level 3 scales, floors and fractions,
    19 for the corner weights, 16 per feature for the corner sum."""
    return spec.n_levels * (9 + 19 + 16 * spec.features_per_level)


def enc_ops_grid(spec) -> int:
    """K8's: the finest coordinates (9), then per level 12 for the level
    fractions, 19 for the weights, 16 per feature for the corner sum."""
    return 9 + spec.n_levels * (12 + 19 + 16 * spec.features_per_level)


def mlp_fwd_ops(spec) -> int:
    h, e = spec.hidden_dim, spec.encoding_dim
    return 4 * h * e + 4 * h + 8 * h + 8


def sigma_ops(spec) -> int:
    h, e = spec.hidden_dim, spec.encoding_dim
    return 2 * h * e + 4 * h + 2


def mlp_bwd_ops(spec) -> int:
    """The heads' adjoint, d(encoding) and the MLP gradient products."""
    h, e = spec.hidden_dim, spec.encoding_dim
    n_sc = 2 * h * e + 6 * h + 4
    return 12 + 10 * h + 4 * h * e + 2 * n_sc


def k7f_ops(spec) -> int:
    return enc_ops_hash(spec) + mlp_fwd_ops(spec) + RECUR_OPS


def k7b_ops(spec) -> int:
    """The forward once (K7f's count), the adjoint, the MLP adjoint and a
    product and an add for each of the 8*L*F table products."""
    table = 2 * 8 * spec.n_levels * spec.features_per_level
    return k7f_ops(spec) + ADJ_OPS + mlp_bwd_ops(spec) + table


def k8f_ops(spec) -> int:
    return enc_ops_grid(spec) + mlp_fwd_ops(spec) + RECUR_OPS


def k8b_ops(spec) -> int:
    """As K7b's, with K8's encoding and C = L*8*F slot-row columns."""
    cols = spec.n_levels * 8 * spec.features_per_level
    return k8f_ops(spec) + ADJ_OPS + mlp_bwd_ops(spec) + 2 * cols


def live_samples(samp) -> int:
    """Masked-in samples of a (T, nc, 3, 16, 128) u16 sample block: bit
    15 of the lane plane (the sign bit of its int16 view)."""
    import torch

    return int((samp[:, :, 2].view(torch.int16) < 0).sum())


def take(x, idx):
    """x[idx] along dim 0, contiguous; CUDA indexes no uint16 tensor, so
    those go through their int16 view."""
    import torch

    if x.dtype == torch.uint16:
        return x.view(torch.int16)[idx].contiguous().view(torch.uint16)
    return x[idx].contiguous()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = ops / F32_OPS_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def headline_scene(P, width=512, height=512, grid_n=64, max_steps=128):
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
    config = P.DenseGridConfig(resolution=(grid_n,) * 3,
                               sigma=sigma.reshape(-1),
                               color=color.reshape(-1))
    return plan, config


def small_scene(P, seed=3):
    """The tests' scene (tests/test_tiled.py::scene): 48x32 rays, 8^3."""
    rng = np.random.default_rng(seed)
    n, width, height = 8, 48, 32
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=height, t_near=0.1, t_far=3.1, seed=17,
        camera=P.CameraConfig(
            k=(width * 1.25, 0, width / 2, 0, width * 1.25, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.55, 0, 0, 1, -1.1)),
        sampling=P.SamplingConfig(dt=0.05, max_steps=60,
                                  mode=P.SamplingMode.STRATIFIED)))
    config = P.DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0.5, 8.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3),
        bbox_min=(0.3, 0.3, 0.2), bbox_max=(0.8, 0.9, 0.7))
    return plan, config


def timed_once(torch, fn):
    """(``fn()``, its ms): one cold run between CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def head_errors(torch, fused_tiles, plan, a, b):
    """(max |diff| over r, g, b, T, opacity; max |diff| of depth)."""
    (ra, ga, ba), ta, oa, da = fused_tiles.finalize_heads(plan, a)
    (rb, gb, bb), tb, ob, db = fused_tiles.finalize_heads(plan, b)
    err = max(float((x - y).abs().max())
              for x, y in ((ra, rb), (ga, gb), (ba, bb), (ta, tb), (oa, ob)))
    return err, float((da - db).abs().max())


def planes_errors(planes, ref):
    """Max |diff| of ForwardResult-style flat arrays against ImagePlanes."""
    err = max(float(np.abs(getattr(planes, k)
                           - getattr(ref, k).cpu().numpy().reshape(-1)).max())
              for k in ("image", "transmittance", "opacity"))
    depth = float(np.abs(planes.depth
                         - ref.depth.cpu().numpy().reshape(-1)).max())
    hit = np.array_equal(planes.hitmask,
                         ref.hitmask.cpu().numpy().reshape(-1))
    return err, depth, hit


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)


DENSE_KERNELS = {   # counter name -> wrapper, in ops.fused_tiles or
    #                 ops.packed_transpose
    "fused_tiles": "tile_forward", "fused_tiles_bwd": "tile_backward",
    "packed_table": "build_rows", "packed_table_bwd": "table_grad_to_params",
    "packed_table16": "build_rows16",
    "packed_table16_bwd": "table16_grad_to_params"}
DENSE_F32 = ("fused_tiles", "packed_table", "fused_tiles_bwd",
             "packed_table_bwd")    # the float32 route's kernels


def _wrappers(fused_tiles, packed_transpose) -> dict:
    return {k: getattr(fused_tiles if k.startswith("fused")
                       else packed_transpose, fn)
            for k, fn in DENSE_KERNELS.items()}


def launch_counts(fused_tiles, packed_transpose) -> dict:
    return {k: w.launches
            for k, w in _wrappers(fused_tiles, packed_transpose).items()}


def reset_counts(fused_tiles, packed_transpose) -> None:
    for w in _wrappers(fused_tiles, packed_transpose).values():
        w.launches = 0


def tiled_grads(torch, P, tiled, plan, field, sched, dl_img, use_kernel):
    """d sum(image * dl_img) in (sigma, color, c2w, k), or (bricks, c2w,
    k) for a sparse field, through ``render_tiled``: what
    ``Renderer.backward`` computes, with the kernels or with their plain
    twins."""
    from dvren_tpu_torch.ops.raygen import camera_arrays

    k, c2w, _ = camera_arrays(plan, dl_img.device)
    k.requires_grad_(True)
    c2w.requires_grad_(True)
    if hasattr(field, "bricks"):
        leaf = field.with_params(field.bricks.detach().clone())
        params = (leaf.bricks,)
    else:
        leaf = field.with_params(field.sigma.detach().clone(),
                                 field.color.detach().clone())
        params = (leaf.sigma, leaf.color)
    planes = tiled.render_tiled(plan, leaf, sched, use_kernel=use_kernel,
                                k=k, c2w=c2w)
    return torch.autograd.grad(torch.sum(planes.image * dl_img),
                               params + (c2w, k))


def run_tables(torch, P, dev, plan, config, renderer, f32_result,
               k2_rows) -> tuple[list, dict]:
    """Phases 21-27: the dense headline with 16-bit packed tables (K5a,
    K5b) and as sparse bricks, through Renderer.forward, .backward and
    SGD steps. ``renderer`` holds the headline's schedule (the dtype does
    not change it), ``f32_result`` is its float32 frame and ``k2_rows``
    K2's slot rows for a seeded cotangent (phase 7)."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.ops.grid import _shift_stack_fullpitch
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import tiled

    sched = renderer._tiled_schedule
    n_groups = len(sched.groups)
    base = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    sigma, color = base.sigma, base.color
    n_rows = packed_transpose.fullpitch_rows(sigma.shape)
    dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16}
    c_max = max(c_k for _, _, c_k in sched.gather_plan.meta)
    ulp = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
    gen = torch.Generator(device=dev).manual_seed(21)
    counts = functools.partial(launch_counts, fused_tiles, packed_transpose)
    reset = functools.partial(reset_counts, fused_tiles, packed_transpose)
    report = {}

    # 21. K5a against its twin at 64^3, bfloat16 and float16
    k5a_err = 0.0
    for name, dt in dtypes.items():
        got = packed_transpose.build_rows16(sigma, color, dt)
        torch.cuda.synchronize()
        want = packed_transpose.build_rows16_plain(sigma, color, dt)
        require(got.dtype == dt and torch.equal(got.view(torch.int16),
                                                want.view(torch.int16)),
                f"K5a differs from its plain twin ({name})")
        k5a_err = max(k5a_err, float((got.float() - want.float()).abs().max()))
    print(f"K5a == plain, bit for bit, bfloat16 and float16: "
          f"{tuple(got.shape)}", flush=True)

    # 22. Renderer.forward on the 16-bit fields (the headline's schedule)
    fields16 = {name: base.with_packed_dtype(name) for name in dtypes}
    fwd16 = {}
    for name, f16 in fields16.items():
        reset()
        res = renderer.forward(f16)
        c = counts()
        print(f"{name} Renderer.forward: {res.stats.total_ms:.3f} ms, "
              f"launches {c}, notes {res.stats.notes}", flush=True)
        # the Renderer keys its schedule by the table's dtype (the
        # cascade depends on it), so it builds one: the same 16 px cells
        s16 = renderer._tiled_schedule
        require(c["packed_table16"] == 1 and c["packed_table"] == 0
                and c["fused_tiles"] == n_groups
                and "kernel_launches=packed_table16:1" in res.stats.notes
                and (s16.tile_px, s16.cell_scale) == (16, 1)
                and torch.equal(s16.hostmap_all, sched.hostmap_all),
                f"the {name} forward did not launch K5a once and K1 per "
                f"group on the headline's schedule")
        for key in ("image", "transmittance", "opacity", "depth"):
            require(bool(np.isfinite(getattr(res, key)).all()),
                    f"{name} {key} not finite")
        with torch.no_grad():
            plain = tiled.render_tiled(plan, f16, sched, use_kernel=False)
        err, depth, hit = planes_errors(res, plain)
        vs32 = max(float(np.abs(getattr(res, k) - getattr(f32_result, k))
                         .max()) for k in ("image", "transmittance",
                                           "opacity"))
        print(f"{name} forward vs plain path: planes {err:.3e}, depth "
              f"{depth:.3e}, hitmask equal {hit}; vs the float32 frame "
              f"{vs32:.3e}", flush=True)
        require(err <= TOL and depth <= TOL_DEPTH and hit,
                f"the {name} forward differs from the plain path")
        require(vs32 <= 5e-3, f"the {name} frame is off the float32 frame")
        fwd16[name] = {"result": res, "vs_plain": err, "vs_f32": vs32,
                       "launches": c}

    # 23. K5b against its twin on the headline's table gradient (K2's slot
    # rows through the 16-bit reduction)
    tg16 = {name: tiled.slot_rows_to_table_as(k2_rows, sched.gather_plan,
                                              n_rows, dt)
            for name, dt in dtypes.items()}
    k5b_err = 0.0
    for name, tg in tg16.items():
        got = packed_transpose.table16_grad_to_params(tg, sigma.shape)
        torch.cuda.synchronize()
        want = packed_transpose.table16_grad_to_params_plain(tg, sigma.shape)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K5b differs from its plain twin ({name})")
        k5b_err = max(k5b_err, max(float((a - b).abs().max())
                                   for a, b in zip(got, want)))
    print("K5b == plain, bit for bit, bfloat16 and float16", flush=True)

    # 24. Renderer.backward on the 16-bit fields, deterministic
    dl = (torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
          - 1).cpu().numpy()
    dl_img = renderer._dl_image(dl)
    bwd16 = {}
    for name, f16 in fields16.items():
        renderer.forward(f16)
        reset()
        torch.use_deterministic_algorithms(True)
        try:
            g1 = renderer.backward(f16, dl)
            c = counts()
            g2 = renderer.backward(f16, dl)
        finally:
            torch.use_deterministic_algorithms(False)
        require(c["fused_tiles_bwd"] == n_groups
                and c["packed_table16"] == 1
                and c["packed_table16_bwd"] == 1
                and c["packed_table"] == 0 and c["packed_table_bwd"] == 0,
                f"the {name} backward did not launch K2 per group, K5a and "
                f"K5b once: {c}")
        for key in ("sigma", "color", "camera", "camera_k"):
            x = getattr(g1, key)
            require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                    f"{name} backward {key} not finite or zero")
            require(np.array_equal(x, getattr(g2, key)),
                    f"{name} backward {key} differs between two calls")
        plain_g = tiled_grads(torch, P, tiled, plan, f16, sched, dl_img,
                              use_kernel=False)
        errs = [rel_err(torch.from_numpy(getattr(g1, k)),
                        plain_g[i].reshape(-1).cpu())
                for i, k in enumerate(("sigma", "color"))]
        tol = c_max * ulp[name]
        print(f"{name} Renderer.backward: launches {c}; vs plain path sigma "
              f"{errs[0]:.3e}, color {errs[1]:.3e} x scale (bound c * ulp = "
              f"{tol:.3e}, c = {c_max}); two calls equal", flush=True)
        require(max(errs) <= tol,
                f"the {name} backward differs from the plain path")
        bwd16[name] = {"launches": c, "vs_plain": errs}

    # 25. bfloat16 training steps through autograd of render_tiled
    target = torch.zeros((plan.height, plan.width, 3), device=dev)
    n_values = plan.height * plan.width * 3

    def sgd_trainer(field_t, sched_t, lr, use_kernel=True):
        opt = torch.optim.SGD(field_t.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled(plan, field_t, sched_t,
                                          use_kernel=use_kernel).image,
                       target)
            loss.backward()
            opt.step()
            return loss

        return step

    def four_steps(field_t, sched_t, expect):
        step = sgd_trainer(field_t, sched_t, LR * n_values)
        losses = []
        reset()
        for _ in range(4):
            before = counts()
            losses.append(float(step().detach()))
            after = counts()
            delta = {k: after[k] - before[k] for k in after}
            require(all((delta[k] > 0) == (k in expect) for k in delta),
                    f"a step launched other kernels than {expect}: {delta}")
        require(all(np.isfinite(losses))
                and all(b < a for a, b in zip(losses, losses[1:])),
                f"the loss does not fall: {losses}")
        return losses, counts()

    bf16_losses, bf16_launches = four_steps(
        P.DenseGridField.create(config, device=dev).with_packed_dtype(
            "bfloat16"), sched,
        ("fused_tiles", "fused_tiles_bwd", "packed_table16",
         "packed_table16_bwd"))
    print(f"4 SGD steps on the bfloat16 table at lr {LR} x {n_values}: loss "
          f"{bf16_losses}; launches {bf16_launches}", flush=True)

    # 26. sparse bricks at threshold 0: every brick is kept
    t0 = time.perf_counter()
    sp32 = P.SparseGridField.from_dense(base, threshold=0.0, device=dev)
    from_dense_s = time.perf_counter() - t0
    sp16 = P.SparseGridField.from_dense(base, threshold=0.0,
                                        dtype="bfloat16", device=dev)
    sp32.requires_grad_(False)
    sp16.requires_grad_(False)
    print(f"SparseGridField.from_dense {from_dense_s:.3f} s: "
          f"{sp32.occupied_bricks} of {sp32.total_bricks} bricks occupied, "
          f"{sp32.memory_bytes() / 1e6:.1f} MB (f32), "
          f"{sp16.memory_bytes() / 1e6:.1f} MB (bf16)", flush=True)
    require(sp32.occupied_bricks == sp32.total_bricks,
            "threshold 0 dropped a brick of a field positive everywhere")
    s_renderer = P.Renderer(P.Context.create(device="cuda"), plan)
    sp_res = {}
    for name, sp in (("float32", sp32), ("bfloat16", sp16)):
        reset()
        res = s_renderer.forward(sp)
        c = counts()
        print(f"sparse {name} Renderer.forward: {res.stats.total_ms:.3f} ms, "
              f"launches {c}, notes {res.stats.notes}", flush=True)
        s_groups = len(s_renderer._tiled_schedule.groups)
        require(c["fused_tiles"] == s_groups and c["packed_table"] == 0
                and c["packed_table16"] == 0,
                f"the sparse {name} forward did not launch K1 alone")
        require(s_renderer._tiled_schedule.table_kind == "sparse",
                "the sparse forward did not take a sparse schedule")
        ref = f32_result if name == "float32" else fwd16[name]["result"]
        diff = max(float(np.abs(getattr(res, k) - getattr(ref, k)).max())
                   for k in ("image", "transmittance", "opacity", "depth"))
        print(f"sparse {name} frame vs dense {name} frame: max |diff| "
              f"{diff:.3e}", flush=True)
        require(diff == 0.0,
                f"the sparse {name} frame differs from the dense one")
        sp_res[name] = {"result": res, "vs_dense": diff, "launches": c}
    s_sched = s_renderer._tiled_schedule
    s_c = max(c_k for _, _, c_k in s_sched.gather_plan.meta)
    sp_bwd = {}
    for name, sp in (("float32", sp32), ("bfloat16", sp16)):
        s_renderer.forward(sp)
        reset()
        torch.use_deterministic_algorithms(True)
        try:
            g1 = s_renderer.backward(sp, dl)
            c = counts()
            g2 = s_renderer.backward(sp, dl)
        finally:
            torch.use_deterministic_algorithms(False)
        require(g1.bricks.shape == tuple(sp.bricks.shape)
                and g1.sigma.size == 0, "sparse backward shapes")
        for key in ("bricks", "camera", "camera_k"):
            x = getattr(g1, key)
            require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                    f"sparse {name} backward {key} not finite or zero")
            require(np.array_equal(x, getattr(g2, key)),
                    f"sparse {name} backward {key} differs between calls")
        plain_g = tiled_grads(torch, P, tiled, plan, sp, s_sched, dl_img,
                              use_kernel=False)
        err = rel_err(torch.from_numpy(g1.bricks), plain_g[0].float().cpu())
        tol = GRID_TOL if name == "float32" else s_c * ulp[name]
        print(f"sparse {name} Renderer.backward: launches {c}; d(bricks) vs "
              f"plain path {err:.3e} x scale (bound {tol:.3e}); two calls "
              f"equal", flush=True)
        require(c["fused_tiles_bwd"] == len(s_sched.groups)
                and c["packed_table_bwd"] == 0
                and c["packed_table16_bwd"] == 0,
                f"the sparse backward launched other kernels: {c}")
        require(err <= tol, f"the sparse {name} backward differs from the "
                            f"plain path")
        sp_bwd[name] = {"vs_plain": err, "launches": c}
    sp_losses, sp_launches = four_steps(
        P.SparseGridField.from_dense(base, threshold=0.0, device=dev),
        s_sched, ("fused_tiles", "fused_tiles_bwd"))
    print(f"4 SGD steps on the float32 bricks at lr {LR} x {n_values}: loss "
          f"{sp_losses}; launches {sp_launches}", flush=True)

    # 27. times (CUDA events) and the peak device memory each adds
    def peak_from_here():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def added_peak_mb(base_bytes):
        return (torch.cuda.max_memory_allocated() - base_bytes) / 2 ** 20

    times, peaks = {}, {}
    with torch.no_grad():
        for name, f, sch in (("bfloat16", fields16["bfloat16"], sched),
                             ("float16", fields16["float16"], sched),
                             ("sparse_float32", sp32, s_sched),
                             ("sparse_bfloat16", sp16, s_sched)):
            b0 = peak_from_here()
            times[f"frame_{name}"] = cuda_ms(
                torch, lambda f=f, sch=sch: tiled.render_tiled(plan, f, sch),
                FRAMES, warmup=3)
            peaks[f"frame_{name}"] = added_peak_mb(b0)
        times["plain_frame_bfloat16"] = cuda_ms(
            torch, lambda: tiled.render_tiled(plan, fields16["bfloat16"],
                                              sched, use_kernel=False),
            1, warmup=1)
        times["plain_frame_sparse_float32"] = cuda_ms(
            torch, lambda: tiled.render_tiled(plan, sp32, s_sched,
                                              use_kernel=False), 1, warmup=1)
    for name, make, sch in (
            ("bfloat16", lambda: P.DenseGridField.create(
                config, device=dev).with_packed_dtype("bfloat16"), sched),
            ("sparse_float32", lambda: P.SparseGridField.from_dense(
                base, threshold=0.0, device=dev), s_sched)):
        b0 = peak_from_here()
        times[f"step_{name}"] = cuda_ms(torch, sgd_trainer(make(), sch, LR),
                                        STEPS, warmup=2)
        peaks[f"step_{name}"] = added_peak_mb(b0)
        times[f"plain_step_{name}"] = cuda_ms(
            torch, sgd_trainer(make(), sch, LR, use_kernel=False), 1,
            warmup=1)
    k5 = {}
    for name, dt in dtypes.items():
        stack = _shift_stack_fullpitch(sigma, color, n_rows).to(dt)
        rows32 = tg16[name].float()
        k5[name] = {
            "k5a": cuda_ms(torch, lambda dt=dt: packed_transpose.build_rows16(
                sigma, color, dt), 50),
            "k5a_plain": cuda_ms(
                torch, lambda dt=dt: packed_transpose.build_rows16_plain(
                    sigma, color, dt), 50),
            "k5a_library": cuda_ms(torch, lambda s=stack: s.t().contiguous(),
                                   50),
            "k5b": cuda_ms(
                torch, lambda tg=tg16[name]:
                packed_transpose.table16_grad_to_params(tg, sigma.shape), 50),
            "k5b_plain": cuda_ms(
                torch, lambda tg=tg16[name]:
                packed_transpose.table16_grad_to_params_plain(
                    tg, sigma.shape), 20),
            "k5b_library": cuda_ms(torch, lambda r=rows32: r.t().contiguous(),
                                   50)}
    n_rays = plan.ray_count
    print("16-bit and sparse times ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    print("Mrays/s: " + ", ".join(
        f"{k} {n_rays / v / 1e3:.3f}" for k, v in times.items()
        if not k.startswith("plain")), flush=True)
    print("peak device memory added MiB: " + ", ".join(
        f"{k} {v:.1f}" for k, v in peaks.items()), flush=True)
    for name, t in k5.items():
        print(f"{name}: K5a {t['k5a']:.4f} ms (plain {t['k5a_plain']:.4f}, "
              f"stack.t().contiguous() {t['k5a_library']:.4f}); K5b "
              f"{t['k5b']:.4f} ms (plain {t['k5b_plain']:.4f}, "
              f"rows.t().contiguous() {t['k5b_library']:.4f})", flush=True)

    t16 = packed_transpose.build_rows16(sigma, color, torch.bfloat16)
    k5b_out = packed_transpose.table16_grad_to_params(tg16["bfloat16"],
                                                      sigma.shape)
    kernels = [
        {"name": "packed_table16", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table16.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:40",
         "launches": fwd16["bfloat16"]["launches"]["packed_table16"],
         "max_abs_err": k5a_err, "ms": k5["bfloat16"]["k5a"],
         "plain_ms": k5["bfloat16"]["k5a_plain"],
         **bound(nbytes(sigma, color, t16), 0),
         "library_ms": k5["bfloat16"]["k5a_library"]},
        {"name": "packed_table16_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table16_bwd.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:63",
         "launches": bf16_launches["packed_table16_bwd"],
         "max_abs_err": k5b_err, "ms": k5["bfloat16"]["k5b"],
         "plain_ms": k5["bfloat16"]["k5b_plain"],
         **bound(nbytes(tg16["bfloat16"], *k5b_out),
                 8 * sum(x.numel() for x in k5b_out)),
         "library_ms": k5["bfloat16"]["k5b_library"]},
    ]
    report.update({
        "times_ms": times, "added_peak_mib": peaks, "k5_ms": k5,
        "forward16_vs_plain": {k: v["vs_plain"] for k, v in fwd16.items()},
        "forward16_vs_f32": {k: v["vs_f32"] for k, v in fwd16.items()},
        "backward16_vs_plain": {k: v["vs_plain"] for k, v in bwd16.items()},
        "sparse_vs_dense": {k: v["vs_dense"] for k, v in sp_res.items()},
        "sparse_backward_vs_plain": {k: v["vs_plain"]
                                     for k, v in sp_bwd.items()},
        "bf16_losses": bf16_losses, "sparse_losses": sp_losses,
        "sparse_from_dense_s": from_dense_s,
        "sparse_memory_mb": [sp32.memory_bytes() / 1e6,
                             sp16.memory_bytes() / 1e6],
        "slot_class_max": [c_max, s_c]})
    return kernels, report


def hash_headline(P, width=512, max_steps=128):
    """tools/hashmlp_bench.py's plan (seed 5, stratified) and spec."""
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=width, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(width * 1.2, 0, width / 2, 0, width * 1.2, width / 2, 0, 0,
               1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / max_steps, max_steps=max_steps,
                                  mode=P.SamplingMode.STRATIFIED)))
    spec = P.HashMLPSpec(n_levels=8, table_size=128, base_resolution=2.0,
                         finest_resolution=48.0)
    return plan, spec


def hash_fit_setup(P, views=4, width=96):
    """tools/hashmlp_bench.py's fit: 4 views at 96^2 on a y-axis orbit of
    radius 1.5 around (0.5, 0.5, 0.5), 64 fixed steps."""
    plan = P.Plan.create(P.PlanConfig(
        width=width, height=width, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(width * 1.2, 0, width / 2, 0, width * 1.2, width / 2, 0, 0,
               1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / 64, max_steps=64)))
    center = np.array([0.5, 0.5, 0.5], np.float32)
    cams = []
    for v in range(views):
        th = 2 * np.pi * v / views
        eye = center + 1.5 * np.array([np.sin(th), 0.0, -np.cos(th)],
                                      np.float32)
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(np.array([0.0, 1.0, 0.0], np.float32), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        c2w = np.concatenate([np.stack([right, up, fwd], axis=1),
                              eye.reshape(3, 1)], axis=1)
        cams.append(P.CameraConfig(
            k=plan.camera.k, c2w=tuple(float(x) for x in c2w.reshape(-1))))
    return plan, cams


def hash_small_scene(P, device=None):
    """tests/test_hash_tiled.py's stratified case: 24x20, default spec."""
    plan = P.Plan.create(P.PlanConfig(
        width=24, height=20, t_near=0.2, t_far=1.8, seed=11,
        sampling=P.SamplingConfig(dt=0.05, max_steps=24,
                                  mode=P.SamplingMode.STRATIFIED)))
    spec = P.HashMLPSpec()
    flat = np.random.default_rng(5).uniform(
        -0.5, 0.5, spec.param_count).astype(np.float32)
    return plan, P.HashMLPField.create(P.HashMLPConfig(spec=spec,
                                                       params=flat),
                                       device=device)


def hash_counts(hash_tiles) -> dict:
    return {"hash_tiles": hash_tiles.hash_tile_forward.launches,
            "hash_tiles_bwd": hash_tiles.hash_tile_backward.launches}


def reset_hash_counts(hash_tiles) -> None:
    hash_tiles.hash_tile_forward.launches = 0
    hash_tiles.hash_tile_backward.launches = 0


def run_hash(torch, P, dev) -> tuple[list, dict]:
    """Phases 11-15: the hash-MLP field's forward, backward and fit."""
    from dvren_tpu_torch.ops import fused_tiles, hash_tiles
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import hash_tiled

    # 11. K7f against its plain twin at the hash headline
    plan, spec = hash_headline(P)
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                       spec=spec, device=dev)
    field.requires_grad_(False)
    t0 = time.perf_counter()
    sched_host = hash_tiled.build_hash_schedule(plan)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = sched_host.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    print(f"hash schedule build {build_s:.3f} s, upload {upload_s:.3f} s: "
          f"{sched.n_tiles} tiles x {sched.n_chunks} chunks, sample_t "
          f"{sched.samp.numel() * 4 / 2 ** 20:.1f} MiB", flush=True)
    params = dict(field.params)
    prm = hash_tiles.hash_tile_params(plan, spec, sched.n_chunks)
    table = params["hash_table"].contiguous()
    sc = hash_tiles.pack_mlp_scalars(params, spec)
    args = (sched.samp, sched.rayt, table, sc, prm)
    out_k = hash_tiles.hash_tile_forward(*args)
    torch.cuda.synchronize()
    out_p = hash_tiles.hash_tile_forward_plain(*args)
    require(bool(torch.isfinite(out_k).all()), "K7f output not finite")
    k7f_err, k7f_depth = head_errors(torch, fused_tiles, plan, out_k, out_p)
    k7f_raw = float((out_k - out_p).abs().max())
    print(f"K7f vs plain: heads {k7f_err:.3e}, depth {k7f_depth:.3e}, raw "
          f"{k7f_raw:.3e}", flush=True)
    require(k7f_err <= TOL and k7f_depth <= TOL_DEPTH,
            "K7f differs from its plain twin beyond tolerance")

    # 12. Renderer.forward on the hash field, end to end
    renderer = P.Renderer(P.Context.create(device="cuda"), plan)
    reset_hash_counts(hash_tiles)
    result = renderer.forward(field)
    fwd_launches = hash_counts(hash_tiles)
    print(f"hash Renderer.forward: {result.stats.total_ms:.3f} ms (schedule "
          f"included), launches {fwd_launches}, notes "
          f"{result.stats.notes}", flush=True)
    require(fwd_launches["hash_tiles"] == 1
            and "hash_tiled_path" in result.stats.notes
            and "kernel_launches=hash_tiles:1" in result.stats.notes,
            "the hash Renderer.forward did not launch K7f")
    for name in ("image", "transmittance", "opacity", "depth"):
        require(bool(np.isfinite(getattr(result, name)).all()),
                f"hash {name} not finite")
    require(float(result.opacity.max()) > 0.0, "hash opacity is 0 "
            "everywhere")
    with torch.no_grad():
        plain = hash_tiled.render_hash_tiled(plan, field,
                                             renderer._hash_schedule,
                                             use_kernel=False)
    e2e_err, e2e_depth, hit_ok = planes_errors(result, plain)
    print(f"hash forward vs plain path: planes {e2e_err:.3e}, depth "
          f"{e2e_depth:.3e}, hitmask equal {hit_ok}; opacity max "
          f"{float(result.opacity.max()):.6f} mean "
          f"{float(result.opacity.mean()):.6f}", flush=True)
    require(e2e_err <= TOL and e2e_depth <= TOL_DEPTH and hit_ok,
            "hash forward differs from the plain path")
    s_plan, s_field = hash_small_scene(P, dev)
    s_out = P.Renderer(P.Context.create(device="cuda"), s_plan).forward(
        s_field)
    s_ref = P.Renderer(P.Context.create(device="cpu"), s_plan,
                       P.RenderOptions(use_tiles=True)).forward(
        hash_small_scene(P, "cpu")[1])
    s_err = max(float(np.abs(getattr(s_out, k) - getattr(s_ref, k)).max())
                for k in ("image", "transmittance", "opacity"))
    s_depth = float(np.abs(s_out.depth - s_ref.depth).max())
    print(f"small hash scene, card vs CPU plain: planes {s_err:.3e}, depth "
          f"{s_depth:.3e}", flush=True)
    require(s_err <= TOL and s_depth <= TOL_DEPTH
            and np.array_equal(s_out.hitmask, s_ref.hitmask),
            "small hash scene on the card differs from the CPU")

    # 13. K7b against its plain twin (tile subset); repeats on the frame
    gen = torch.Generator(device=dev).manual_seed(7)
    gs = torch.randn((sched.n_tiles, 5, 16, 16), generator=gen, device=dev)
    step = sched.n_tiles // HASH_SUBSET
    sub = torch.arange(0, sched.n_tiles, step, device=dev)[:HASH_SUBSET]
    sub_args = (sched.samp[sub].contiguous(), sched.rayt[sub].contiguous(),
                table, sc)
    b_tab, b_sc = hash_tiles.hash_tile_backward(*sub_args, gs[sub].contiguous(),
                                                prm)
    torch.cuda.synchronize()
    p_tab, p_sc = hash_tiles.hash_tile_backward_plain(
        *sub_args, gs[sub].contiguous(), prm)
    k7b_tab_err, k7b_sc_err = rel_err(b_tab, p_tab), rel_err(b_sc, p_sc)
    k7b_raw = max(float((b_tab - p_tab).abs().max()),
                  float((b_sc - p_sc).abs().max()))
    full1 = hash_tiles.hash_tile_backward(*args[:4], gs, prm)
    full2 = hash_tiles.hash_tile_backward(*args[:4], gs, prm)
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(x).all()) for x in full1),
            "K7b not finite")
    require(all(torch.equal(a, b) for a, b in zip(full1, full2)),
            "K7b differs between two runs")
    print(f"K7b vs plain on {HASH_SUBSET} tiles: d(table) {k7b_tab_err:.3e} "
          f"x scale, d(MLP) {k7b_sc_err:.3e} x scale (max |diff| "
          f"{k7b_raw:.3e}); two full-frame runs equal", flush=True)
    require(k7b_tab_err <= HASH_GRAD_TOL and k7b_sc_err <= HASH_GRAD_TOL,
            "K7b differs from its plain twin beyond tolerance")

    # 14. fit_hash_mlp toward a teacher of the same spec
    f_plan, cams = hash_fit_setup(P)
    # a denser teacher than the default initialisation (table std 1, not
    # 1e-2), so the targets are not near-empty images
    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, table_std=1.0,
                                         device=dev)
    stack = hash_tiled.build_hash_schedule_stack(
        fit.view_plans(f_plan, cams), device=dev)
    with torch.no_grad():
        targets = hash_tiled.render_hash_tiled_stack(f_plan, teacher, stack)
    student = P.HashMLPField.init_random(torch.Generator().manual_seed(3),
                                         spec=spec, device=dev)
    config = fit.FitConfig(steps=FIT_STEPS, sync_every=FIT_STEPS,
                           learning_rate=8e-3, target_psnr=None)
    reset_hash_counts(hash_tiles)
    res = fit.fit_hash_mlp(f_plan, student, cams, targets, config)
    fit_launches = hash_counts(hash_tiles)
    losses = res.loss_history
    print(f"fit_hash_mlp: {res.steps_run} steps, loss {losses[0]:.6e} -> "
          f"{losses[-1]:.6e} (psnr {res.psnr_history[0]:.3f} -> "
          f"{res.psnr_history[-1]:.3f} dB), launches {fit_launches}, "
          f"schedule {res.schedule_build_s:.3f} s, first step "
          f"{res.first_step_s:.3f} s, steady {res.steady_step_ms:.4f} "
          f"ms/step, wall {res.wall_clock_s:.3f} s", flush=True)
    require(res.steps_run == FIT_STEPS and np.all(np.isfinite(losses)),
            "fit loss not finite")
    require(losses[-1] < losses[0], "fit loss does not fall")
    require(fit_launches["hash_tiles"] == FIT_STEPS
            and fit_launches["hash_tiles_bwd"] == FIT_STEPS,
            f"K7f / K7b did not launch once per fit step: {fit_launches}")
    require(res.steady_step_ms > 0.0, "steady_step_ms is 0")

    # K7f and K7b against their twins at the fit's shapes, for the fitted
    # student and an opaque teacher. A ray stopped early when its optical
    # depth with the stop threshold is below the one without it.
    f_prm = hash_tiles.hash_tile_params(f_plan, spec, stack.n_chunks)
    f_gs = torch.randn((stack.samp.shape[0], 5, 16, 16), generator=gen,
                       device=dev)
    opaque = {k: v.detach().clone() for k, v in teacher.params.items()}
    opaque["sigma_b2"] += OPAQUE_BIAS
    fit_cmp = {}
    with torch.no_grad():
        for name, prms in (("student", res.field.params),
                           ("opaque teacher", opaque)):
            f_args = (stack.samp, stack.rayt,
                      prms["hash_table"].detach().contiguous(),
                      hash_tiles.pack_mlp_scalars(prms, spec))
            o_k = hash_tiles.hash_tile_forward(*f_args, f_prm)
            g_k = hash_tiles.hash_tile_backward(*f_args, f_gs, f_prm)
            torch.cuda.synchronize()
            o_p = hash_tiles.hash_tile_forward_plain(*f_args, f_prm)
            g_p = hash_tiles.hash_tile_backward_plain(*f_args, f_gs, f_prm)
            no_stop = hash_tiles.hash_tile_forward_plain(
                *f_args, dataclasses.replace(f_prm, stop=0.0))
            early = int((o_p[:, 4] < no_stop[:, 4]).sum())
            err, depth = head_errors(torch, fused_tiles, f_plan, o_k, o_p)
            cmp = {"heads": err, "depth": depth,
                   "f_raw": float((o_k - o_p).abs().max()),
                   "table": rel_err(g_k[0], g_p[0]),
                   "mlp": rel_err(g_k[1], g_p[1]),
                   "b_raw": max(float((g_k[0] - g_p[0]).abs().max()),
                                float((g_k[1] - g_p[1]).abs().max())),
                   "early": early}
            fit_cmp[name] = cmp
            print(f"fit shapes, {name}: K7f vs plain heads {err:.3e}, depth "
                  f"{depth:.3e}, raw {cmp['f_raw']:.3e}; K7b vs plain "
                  f"d(table) {cmp['table']:.3e} x scale, d(MLP) "
                  f"{cmp['mlp']:.3e} x scale (max |diff| {cmp['b_raw']:.3e}); "
                  f"{early} of {f_plan.ray_count * len(cams)} rays stop early",
                  flush=True)
            require(err <= TOL and depth <= TOL_DEPTH,
                    f"K7f differs from its twin at the fit's shapes ({name})")
            require(cmp["table"] <= HASH_GRAD_TOL
                    and cmp["mlp"] <= HASH_GRAD_TOL,
                    f"K7b differs from its twin at the fit's shapes ({name})")
    require(fit_cmp["opaque teacher"]["early"] > 0,
            "no ray of the opaque teacher stops early")

    # 15. times; peak device memory above what the earlier phases still
    # hold (the dense scene, both schedules, the teacher's targets)
    def added_peak_mb(base):
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    base = torch.cuda.memory_allocated()
    print(f"allocated before the hash timings {base / 2 ** 20:.1f} MiB",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: hash_tiled.render_hash_tiled(
            plan, field, sched), FRAMES, warmup=3)
        peak_mb = added_peak_mb(base)
        plain_fwd_ms = cuda_ms(torch, lambda: hash_tiled.render_hash_tiled(
            plan, field, sched, use_kernel=False), 1, warmup=1)
    k7f_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_forward(*args), 20)
    k7f_plain_ms = cuda_ms(
        torch, lambda: hash_tiles.hash_tile_forward_plain(*args), 1,
        warmup=1)
    torch.cuda.reset_peak_memory_stats()
    k7b_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_backward(
        *args[:4], gs, prm), 5, warmup=1)
    bwd_peak_mb = added_peak_mb(base)
    k7b_plain_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_backward_plain(
        *args[:4], gs, prm), 1, warmup=0)
    k7b_sub_ms = cuda_ms(torch, lambda: hash_tiles.hash_tile_backward(
        *sub_args, gs[sub].contiguous(), prm), 20)
    k7b_sub_plain_ms = cuda_ms(
        torch, lambda: hash_tiles.hash_tile_backward_plain(
            *sub_args, gs[sub].contiguous(), prm), 1, warmup=1)
    n_rays = plan.ray_count
    print(f"hash forward {fwd_ms:.4f} ms/frame = "
          f"{n_rays / fwd_ms / 1e3:.3f} Mrays/s over {FRAMES} frames (plain "
          f"path {plain_fwd_ms:.4f} ms); K7f {k7f_ms:.4f} ms (plain "
          f"{k7f_plain_ms:.4f}); K7b {k7b_ms:.4f} ms (plain "
          f"{k7b_plain_ms:.4f}), on {HASH_SUBSET} tiles {k7b_sub_ms:.4f} ms "
          f"(plain {k7b_sub_plain_ms:.4f}); peak device memory added: "
          f"forward {peak_mb:.1f} MiB, K7b {bwd_peak_mb:.1f} MiB",
          flush=True)

    trained = student.with_params({k: v.detach().clone()
                                   for k, v in student.params.items()})

    def fit_step(use_kernel, opt, f):
        def step():
            opt.zero_grad(set_to_none=True)
            loss = fit.mse(hash_tiled.render_hash_tiled_stack(
                f_plan, f, stack, use_kernel=use_kernel), targets)
            loss.backward()
            opt.step()
        return step

    opt = torch.optim.Adam(trained.parameters(), lr=8e-3)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fit_ms = cuda_ms(torch, fit_step(True, opt, trained), 20, warmup=2)
    fit_peak_mb = added_peak_mb(base)
    plain_fit_ms = cuda_ms(torch, fit_step(False, opt, trained), 1,
                           warmup=1)
    fit_rays = len(cams) * f_plan.ray_count
    print(f"fit step {fit_ms:.4f} ms/step = {fit_rays / fit_ms / 1e3:.3f} "
          f"Mrays/s over 20 steps (plain path {plain_fit_ms:.4f} ms/step); "
          f"peak device memory added {fit_peak_mb:.1f} MiB", flush=True)

    live = live_samples(sched.samp)
    kernels = [
        {"name": "hash_tiles", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_tiles.cu",
         "replaces": "dvren_tpu/ops/hash_tiles.py:288",
         "launches": fwd_launches["hash_tiles"],
         "max_abs_err": max([k7f_raw] + [c["f_raw"]
                                         for c in fit_cmp.values()]),
         "ms": k7f_ms, "plain_ms": k7f_plain_ms,
         **bound(nbytes(*args[:4], out_k), live * k7f_ops(spec))},
        {"name": "hash_tiles_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/hash_tiles.py:339",
         "launches": fit_launches["hash_tiles_bwd"],
         "max_abs_err": max([k7b_raw] + [c["b_raw"]
                                         for c in fit_cmp.values()]),
         "ms": k7b_ms, "plain_ms": k7b_plain_ms,
         **bound(nbytes(*args[:4], gs, *full1), live * k7b_ops(spec))},
    ]
    report = {
        "hash_forward_ms": fwd_ms, "hash_forward_mrays_s":
            n_rays / fwd_ms / 1e3,
        "hash_plain_forward_ms": plain_fwd_ms,
        "hash_schedule_build_s": build_s, "hash_schedule_upload_s": upload_s,
        "hash_forward_added_peak_mib": peak_mb,
        "k7b_added_peak_mib": bwd_peak_mb,
        "k7f_ms": k7f_ms, "k7b_ms": k7b_ms,
        "k7b_subset_ms": k7b_sub_ms, "k7b_subset_plain_ms": k7b_sub_plain_ms,
        "k7b_rel_err": [k7b_tab_err, k7b_sc_err],
        "fit_shape_compares": fit_cmp,
        "hash_forward_vs_plain": e2e_err,
        "fit_step_ms": fit_ms, "fit_plain_step_ms": plain_fit_ms,
        "fit_mrays_s": fit_rays / fit_ms / 1e3,
        "fit_added_peak_mib": fit_peak_mb,
        "fit_losses": [losses[0], losses[-1]],
        "fit_steady_step_ms": res.steady_step_ms,
        "fit_first_step_s": res.first_step_s,
        "fit_schedule_build_s": res.schedule_build_s}
    return kernels, report


def grid_small_scene(torch, P, device=None):
    """tests/test_hash_grid.py's scene: 32^2, 16 fixed steps, L=3 / F=2 /
    T=4096 on the 2-4-8 ladder, a field from a seeded generator."""
    w, steps = 32, 16
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps)))
    spec = P.HashMLPSpec(n_levels=3, features_per_level=2, table_size=4096,
                         base_resolution=2.0, finest_resolution=8.0,
                         resolutions=(2, 4, 8))
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(4),
                                       spec=spec, table_std=0.5,
                                       device=device)
    return plan, field


def image_errors(a, b):
    """(max |diff| over image, transmittance, opacity; depth; hitmask
    equal) of two ImagePlanes."""
    def diff(k):
        return (getattr(a, k).cpu() - getattr(b, k).cpu()).abs().max()

    err = max(float(diff(k)) for k in ("image", "transmittance", "opacity"))
    return (err, float(diff("depth")),
            bool((a.hitmask.cpu() == b.hitmask.cpu()).all()))


def grid_counts(hash_grid) -> dict:
    return {"hash_grid": hash_grid.hash_grid_forward.launches,
            "hash_grid_bwd": hash_grid.hash_grid_backward.launches}


def reset_grid_counts(hash_grid) -> None:
    hash_grid.hash_grid_forward.launches = 0
    hash_grid.hash_grid_backward.launches = 0


def run_grid(torch, P, dev) -> tuple[list, dict]:
    """Phases 16-20: the NGP-scale hash grid path."""
    from dvren_tpu_torch.ops import (fused_tiles, gather_plan, hash_grid,
                                     hash_tiles)
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import hash_tiled, tiled

    # 16. the grid headline's schedule; K8f against its twin on every group
    print(card_line(), flush=True)
    plan, _ = hash_headline(P)
    spec = P.HashMLPSpec(**GRID_SPEC)
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                       spec=spec, device=dev)
    t0 = time.perf_counter()
    sched_host = hash_tiled.build_hash_grid_schedule(plan, field)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = sched_host.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    groups = sched.groups
    n_groups = len(groups)
    lanes = sum(g.n_tiles * g.banks for g in groups) * 128
    print(f"grid schedule build {build_s:.3f} s, upload {upload_s:.3f} s: "
          f"{sched.tile_px} px tiles, (n_chunks, n_tiles, banks) "
          f"{[(g.n_chunks, g.n_tiles, g.banks) for g in groups]}, {lanes} "
          f"bank lanes, {sched.tiled_samples} of "
          f"{sched.full_lattice_samples} samples live, fallback_rays "
          f"{sched.fallback_rays}", flush=True)
    require(sched.tile_px == 16 and sched.fallback_rays == 0
            and n_groups == GRID_GROUPS,
            "the grid headline's schedule is not 16 px tiles in "
            f"{GRID_GROUPS} groups without overflow")
    shapes = [(g.n_tiles, g.banks) for g in groups]
    prms = [hash_grid.grid_op_params(plan, spec, g.banks, g.n_chunks)
            for g in groups]

    def kernel_args(params):
        """(packed table, per-group K8 arguments) for detached params."""
        table = hash_grid.build_hash_grid_table(params, spec)
        tabs = tiled._gather_bank_tables(table, sched.gathermap_all, shapes)
        sc = hash_tiles.pack_mlp_scalars(params, spec)
        return table, [(tabs[i], g.samp, g.base, g.rayt, g.k_enter,
                        g.bank0.reshape(-1), sc, prms[i])
                       for i, g in enumerate(groups)]

    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(2),
                                         spec=spec, table_std=1.0,
                                         device=dev)
    student_p = {k: v.detach() for k, v in field.params.items()}
    opaque_p = {k: v.detach().clone() for k, v in teacher.params.items()}
    opaque_p["sigma_b2"] += GRID_OPAQUE_BIAS
    cmp = {}
    for name, params in (("student", student_p), ("opaque teacher", opaque_p)):
        _, g_args = kernel_args(params)
        c = {"heads": 0.0, "depth": 0.0, "f_raw": 0.0, "early": 0}
        for a in g_args:
            out_k = hash_grid.hash_grid_forward(*a)
            torch.cuda.synchronize()
            out_p = hash_grid.hash_grid_forward_plain(*a)
            require(bool(torch.isfinite(out_k).all()), "K8f output not finite")
            err, depth = head_errors(torch, fused_tiles, plan, out_k, out_p)
            c["heads"], c["depth"] = max(c["heads"], err), max(c["depth"],
                                                               depth)
            c["f_raw"] = max(c["f_raw"], float((out_k - out_p).abs().max()))
            if name != "student":
                no_stop = hash_grid.hash_grid_forward_plain(
                    *a[:7], dataclasses.replace(a[7], stop=0.0))
                c["early"] += int((out_p[:, 4] < no_stop[:, 4]).sum())
        cmp[name] = c
        print(f"K8f vs plain over {n_groups} groups, {name}: heads "
              f"{c['heads']:.3e}, depth {c['depth']:.3e}, raw "
              f"{c['f_raw']:.3e}" + (f"; {c['early']} rays stop early"
                                     if name != "student" else ""),
              flush=True)
        require(c["heads"] <= TOL and c["depth"] <= TOL_DEPTH,
                f"K8f differs from its plain twin beyond tolerance ({name})")
    require(cmp["opaque teacher"]["early"] > 0,
            "no ray of the opaque teacher stops early")

    # 17. render_hash_grid_tiled on the card against the plain path there
    field.requires_grad_(False)
    reset_grid_counts(hash_grid)
    with torch.no_grad():
        out = hash_tiled.render_hash_grid_tiled(plan, field, sched)
        fwd_launches = grid_counts(hash_grid)
        plain = hash_tiled.render_hash_grid_tiled(plan, field, sched,
                                                  use_kernel=False)
    require(fwd_launches == {"hash_grid": n_groups, "hash_grid_bwd": 0},
            f"render_hash_grid_tiled did not launch K8f once per group: "
            f"{fwd_launches}")
    require(all(bool(torch.isfinite(getattr(out, k)).all())
                for k in ("image", "transmittance", "opacity", "depth")),
            "grid planes not finite")
    require(float(out.opacity.max()) > 0.0, "grid opacity is 0 everywhere")
    e2e_err, e2e_depth, hit_ok = image_errors(out, plain)
    print(f"render_hash_grid_tiled: launches {fwd_launches}; vs plain path "
          f"planes {e2e_err:.3e}, depth {e2e_depth:.3e}, hitmask equal "
          f"{hit_ok}; opacity max {float(out.opacity.max()):.6f} mean "
          f"{float(out.opacity.mean()):.6f}", flush=True)
    require(e2e_err <= TOL and e2e_depth <= TOL_DEPTH and hit_ok,
            "the grid forward differs from the plain path")
    s_plan, s_field = grid_small_scene(torch, P, dev)
    _, s_cpu = grid_small_scene(torch, P, "cpu")
    with torch.no_grad():
        s_out = hash_tiled.render_hash_grid_tiled(
            s_plan, s_field,
            hash_tiled.build_hash_grid_schedule(s_plan, s_field, device=dev))
        s_ref = hash_tiled.render_hash_grid_tiled(
            s_plan, s_cpu,
            hash_tiled.build_hash_grid_schedule(s_plan, s_cpu,
                                                device="cpu"))
    s_err, s_depth, s_hit = image_errors(s_out, s_ref)
    print(f"small grid scene, card vs CPU plain: planes {s_err:.3e}, depth "
          f"{s_depth:.3e}", flush=True)
    require(s_err <= TOL and s_depth <= TOL_DEPTH and s_hit,
            "small grid scene on the card differs from the CPU")

    # 18. K8b against its twin on a tile subset; deterministic backwards
    gen = torch.Generator(device=dev).manual_seed(9)
    gss = [torch.randn((g.n_tiles, 5, 16, 16), generator=gen, device=dev)
           for g in groups]

    def subset(a, gs):
        n = a[0].shape[0]
        sub = torch.arange(0, n, max(1, n // GRID_SUBSET),
                           device=dev)[:GRID_SUBSET]
        bank0 = a[5].reshape(n, -1)[sub].reshape(-1)
        return tuple(take(x, sub) for x in a[:5]) + (
            bank0.contiguous(), a[6], gs[sub].contiguous(), a[7])

    for name, params in (("student", student_p), ("opaque teacher", opaque_p)):
        _, g_args = kernel_args(params)
        c = cmp[name]
        c["rows"] = c["mlp"] = c["b_raw"] = 0.0
        for a, gs in zip(g_args, gss):
            sa = subset(a, gs)
            d_rows, d_sc = hash_grid.hash_grid_backward(*sa)
            torch.cuda.synchronize()
            p_rows, p_sc = hash_grid.hash_grid_backward_plain(*sa)
            require(bool(torch.isfinite(d_rows).all()
                         and torch.isfinite(d_sc).all()), "K8b not finite")
            c["rows"] = max(c["rows"], rel_err(d_rows, p_rows))
            c["mlp"] = max(c["mlp"], rel_err(d_sc, p_sc))
            c["b_raw"] = max(c["b_raw"], float((d_rows - p_rows).abs().max()),
                             float((d_sc - p_sc).abs().max()))
        print(f"K8b vs plain on {GRID_SUBSET} tiles per group, {name}: slot "
              f"rows {c['rows']:.3e} x scale, d(MLP) {c['mlp']:.3e} x scale "
              f"(max |diff| {c['b_raw']:.3e})", flush=True)
        require(c["rows"] <= HASH_GRAD_TOL and c["mlp"] <= HASH_GRAD_TOL,
                f"K8b differs from its plain twin beyond tolerance ({name})")

    dl_img = torch.randn((plan.height, plan.width, 3), generator=gen,
                         device=dev)
    keys = sorted(field.params)

    def frame_grads():
        leaf = field.with_params({k: v.detach().clone()
                                  for k, v in field.params.items()})
        img = hash_tiled.render_hash_grid_tiled(plan, leaf, sched).image
        return torch.autograd.grad(torch.sum(img * dl_img),
                                   [leaf.params[k] for k in keys])

    torch.use_deterministic_algorithms(True)
    try:
        g1, g2 = frame_grads(), frame_grads()
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(bool(torch.isfinite(x).all()) for x in g1),
            "grid gradients not finite")
    require(all(torch.equal(a, b) for a, b in zip(g1, g2)),
            "two grid backwards differ")
    require(float(g1[keys.index("hash_table")].abs().max()) > 0.0,
            "d(hash_table) is 0")
    print("two full-frame grid backwards under deterministic algorithms: "
          "equal bit for bit, d(hash_table) included", flush=True)

    # 19. Adam steps through autograd of render_hash_grid_tiled
    with torch.no_grad():
        target = hash_tiled.render_hash_grid_tiled(plan, teacher, sched).image
    student = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, device=dev)

    def trainer(f, use_kernel=True):
        opt = torch.optim.Adam(f.parameters(), lr=8e-3)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(hash_tiled.render_hash_grid_tiled(
                plan, f, sched, use_kernel=use_kernel).image, target)
            loss.backward()
            opt.step()
            return loss

        return step

    step = trainer(student)
    reset_grid_counts(hash_grid)
    losses = []
    for _ in range(GRID_STEPS):
        before = grid_counts(hash_grid)
        losses.append(float(step().detach()))
        after = grid_counts(hash_grid)
        require(all(after[k] - before[k] == n_groups for k in after),
                f"K8f / K8b did not launch once per group in a step: "
                f"{before} -> {after}")
    train_launches = grid_counts(hash_grid)
    print(f"{GRID_STEPS} Adam steps (lr 8e-3) toward the teacher: loss "
          f"{losses[0]:.6e} -> {losses[-1]:.6e}; launches {train_launches}",
          flush=True)
    require(all(np.isfinite(losses)), "grid training loss not finite")
    require(losses[-1] < losses[0], "grid training loss does not fall")

    # 20. times; peak device memory above what is held before each
    def added_peak_mb(base):
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    def peak_from_here():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    base = peak_from_here()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: hash_tiled.render_hash_grid_tiled(
            plan, field, sched), FRAMES, warmup=3)
        fwd_peak = added_peak_mb(base)
        plain_fwd_ms = cuda_ms(
            torch, lambda: hash_tiled.render_hash_grid_tiled(
                plan, field, sched, use_kernel=False), 1, warmup=0)
    table, g_args = kernel_args(student_p)
    table_ms = cuda_ms(torch, lambda: hash_grid.build_hash_grid_table(
        student_p, spec), 50)
    gather_ms = cuda_ms(torch, lambda: tiled._gather_bank_tables(
        table, sched.gathermap_all, shapes), 20)
    k8f_ms = cuda_ms(torch, lambda: [hash_grid.hash_grid_forward(*a)
                                     for a in g_args], 20)
    k8f_plain_ms = cuda_ms(torch, lambda: [
        hash_grid.hash_grid_forward_plain(*a) for a in g_args], 1, warmup=0)
    base = peak_from_here()
    k8b_ms = cuda_ms(torch, lambda: [hash_grid.hash_grid_backward(
        *a[:7], gs, a[7]) for a, gs in zip(g_args, gss)], 5, warmup=1)
    k8b_peak = added_peak_mb(base)
    k8b_plain_ms = cuda_ms(torch, lambda: [
        hash_grid.hash_grid_backward_plain(*a[:7], gs, a[7])
        for a, gs in zip(g_args, gss)], 1, warmup=0)
    b_out = [hash_grid.hash_grid_backward(*a[:7], gs, a[7])
             for a, gs in zip(g_args, gss)]
    cols = hash_grid.packed_cols(spec)
    rows = torch.cat([r.reshape(-1, cols) for r, _ in b_out])
    n_rows = int(table.shape[0])
    reduce_ms = cuda_ms(torch, lambda: gather_plan.slot_rows_to_table(
        rows, sched.gather_plan, n_rows), 20)
    tg = gather_plan.slot_rows_to_table(rows, sched.gather_plan, n_rows)
    adjoint_ms = cuda_ms(torch, lambda: hash_grid.hash_grid_table_grad(
        tg, spec), 20)
    base = peak_from_here()
    step_ms = cuda_ms(torch, step, STEPS, warmup=2)
    step_peak = added_peak_mb(base)
    plain_student = student.with_params({k: v.detach().clone()
                                         for k, v in student.params.items()})
    plain_step_ms = cuda_ms(torch, trainer(plain_student, use_kernel=False),
                            1, warmup=0)
    n_rays = plan.ray_count
    print(f"grid forward {fwd_ms:.4f} ms/frame = {n_rays / fwd_ms / 1e3:.3f} "
          f"Mrays/s over {FRAMES} frames (plain path {plain_fwd_ms:.4f} ms); "
          f"training step {step_ms:.4f} ms/step = "
          f"{n_rays / step_ms / 1e3:.3f} Mrays/s over {STEPS} steps (plain "
          f"path {plain_step_ms:.4f} ms/step)", flush=True)
    print(f"grid stages ms: table build {table_ms:.4f}, bank gather "
          f"{gather_ms:.4f}, K8f {k8f_ms:.4f} over {n_groups} launches "
          f"(plain {k8f_plain_ms:.4f}), K8b {k8b_ms:.4f} (plain "
          f"{k8b_plain_ms:.4f}), slot reduction {reduce_ms:.4f}, table "
          f"adjoint {adjoint_ms:.4f}; peak device memory added: forward "
          f"{fwd_peak:.1f} MiB, K8b {k8b_peak:.1f} MiB, step "
          f"{step_peak:.1f} MiB", flush=True)

    live = sched.tiled_samples
    f_in = sum(nbytes(*a[:7]) for a in g_args)
    f_out = sum(g.n_tiles * 5 * 256 * 4 for g in groups)
    b_bytes = f_in + sum(nbytes(g) for g in gss) + nbytes(rows) + nbytes(
        b_out[0][1])
    kernels = [
        {"name": "hash_grid", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:223",
         "launches": train_launches["hash_grid"],
         "max_abs_err": max(c["f_raw"] for c in cmp.values()),
         "ms": k8f_ms, "plain_ms": k8f_plain_ms,
         **bound(f_in + f_out, live * k8f_ops(spec))},
        {"name": "hash_grid_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid_bwd.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:282",
         "launches": train_launches["hash_grid_bwd"],
         "max_abs_err": max(c["b_raw"] for c in cmp.values()),
         "ms": k8b_ms, "plain_ms": k8b_plain_ms,
         **bound(b_bytes, live * k8b_ops(spec))},
    ]
    report = {
        "schedule_build_s": build_s, "schedule_upload_s": upload_s,
        "forward_ms": fwd_ms, "forward_mrays_s": n_rays / fwd_ms / 1e3,
        "plain_forward_ms": plain_fwd_ms, "forward_vs_plain": e2e_err,
        "stages_ms": {"table_build": table_ms, "bank_gather": gather_ms,
                      "hash_grid": k8f_ms, "hash_grid_bwd": k8b_ms,
                      "slot_reduction": reduce_ms,
                      "table_adjoint": adjoint_ms},
        "plain_stages_ms": {"hash_grid": k8f_plain_ms,
                            "hash_grid_bwd": k8b_plain_ms},
        "step_ms": step_ms, "plain_step_ms": plain_step_ms,
        "step_mrays_s": n_rays / step_ms / 1e3,
        "added_peak_mib": {"forward": fwd_peak, "hash_grid_bwd": k8b_peak,
                           "step": step_peak},
        "losses": losses, "compares": cmp}
    return kernels, report


SUBSET = 8          # tiles per group the sub-tile phases hold to the twins
FIT_VIEWS = 8       # tools/fit_benchmark.py's flagship: 8 views, 96^2, 64^3
FIT_ADAM_STEPS = 10
FIT_LR = 5e-2       # tools/fit_benchmark.py's Adam rate
SUPER_OPS = 3       # a supercell sample's extra adds: base + lb per axis


def flagship_views(P, views=FIT_VIEWS, res=96, grid=64):
    """tools/fit_benchmark.py:58-82 rebuilt in numpy: the truth field (a
    64^3 Gaussian blob), the 96^2 plan (96 fixed steps) and its per-view
    plans on a translation orbit."""
    import math

    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, grid)] * 3), indexing="ij")
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (10.0 * np.exp(-r2 / 0.06)).astype(np.float32)
    color = np.stack([xs, ys, 1 - zs], axis=-1).astype(np.float32)
    config = P.DenseGridConfig(resolution=(grid,) * 3,
                               sigma=sigma.reshape(-1),
                               color=color.reshape(-1))
    plan = P.Plan.create(P.PlanConfig(
        width=res, height=res, t_near=0.2, t_far=2.2,
        camera=P.CameraConfig(k=(res * 1.2, 0, res / 2, 0, res * 1.2,
                                 res / 2, 0, 0, 1)),
        sampling=P.SamplingConfig(dt=2.0 / 96, max_steps=96)))
    cams = []
    for i in range(views):
        ang = 2 * math.pi * i / views
        cams.append(P.CameraConfig(c2w=(
            1, 0, 0, 0.5 + 0.25 * math.sin(ang),
            0, 1, 0, 0.5 + 0.15 * math.cos(ang),
            0, 0, 1, -1.0)))
    from dvren_tpu_torch.opt.fit import view_plans
    return view_plans(plan, cams), config


def schedule_line(sched, build_s) -> str:
    return (f"(tile_px, cell_scale) = ({sched.tile_px}, {sched.cell_scale}), "
            f"{len(sched.groups)} groups, "
            f"{sum(g.n_tiles for g in sched.groups)} tiles, banks <= "
            f"{max(g.banks for g in sched.groups)}, {sched.tiled_samples} "
            f"live samples, fallback rays {sched.fallback_rays}, build "
            f"{build_s:.3f} s")


def build_ms(notes) -> float:
    for n in notes:
        if n.startswith("tiled_schedule_build_ms="):
            return float(n.split("=", 1)[1])
    return float("nan")


def variant_args(torch, plan, field, sched):
    """Every group's K1 arguments on the card for ``sched``'s form, the
    bank tables from the field's table (the supercell table for
    cell_scale 2, else the field's float32 or 16-bit rows)."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.ops.grid import build_supercell_stencil, table_dtype
    from dvren_tpu_torch.render import tiled

    sigma, color = field.sigma.detach(), field.color.detach()
    if sched.cell_scale == 2:
        table = build_supercell_stencil(sigma, color)
    elif field.packed_dtype == "float32":
        table = packed_transpose.build_rows(sigma, color)
    else:
        table = packed_transpose.build_rows16(
            sigma, color, table_dtype(field.packed_dtype))
    tabs = tiled._gather_bank_tables(table, sched.gathermap_all,
                                     [(g.n_tiles, g.banks)
                                      for g in sched.groups])
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    subs = (16 // sched.tile_px) ** 2
    stencil = "super" if sched.cell_scale == 2 else "cell"
    return [(tabs[i], g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1),
             fused_tiles.tile_op_params(plan, geom, g.banks, g.n_chunks, subs,
                                        stencil))
            for i, g in enumerate(sched.groups)]


def subset_args(torch, a, n_tiles):
    """The first ``n_tiles`` tiles of one group's K1 arguments."""
    tabs, samp, base, rayt, ke, bank0, prm = a
    t = min(n_tiles, int(tabs.shape[0]))
    per = bank0.numel() // tabs.shape[0]
    return (tabs[:t].contiguous(), take(samp, slice(0, t)),
            base[:t].contiguous(), rayt[:t].contiguous(), ke[:t].contiguous(),
            bank0[:t * per].contiguous(), prm)


def twins_bit_equal(torch, args, gen, n_tiles=None):
    """K1 and K2 (with the camera adjoint) against their twins on every
    group (the first ``n_tiles`` tiles of each, when given): heads, slot
    rows and d(rayt) equal bit for bit, and K2's repeat too. Returns the
    largest |kernel - twin| (0.0) over K1 and over K2."""
    from dvren_tpu_torch.ops import fused_tiles

    k1_err = k2_err = 0.0
    for a in args:
        if n_tiles is not None:
            a = subset_args(torch, a, n_tiles)
        out = fused_tiles.tile_forward(*a)
        gs = torch.randn((a[0].shape[0], 5, 16, 16), generator=gen,
                         device=a[0].device)
        rows, d_rayt = fused_tiles.tile_backward(*a[:6], gs, a[6], cam=True)
        rows2, d_rayt2 = fused_tiles.tile_backward(*a[:6], gs, a[6], cam=True)
        torch.cuda.synchronize()
        p_out = fused_tiles.tile_forward_plain(*a)
        p_rows, p_rayt = fused_tiles.tile_backward_plain(*a[:6], gs, a[6],
                                                         cam=True)
        require(bool(torch.isfinite(out).all() and torch.isfinite(rows).all()),
                "K1 / K2 output not finite")
        k1_err = max(k1_err, float((out - p_out).abs().max()))
        k2_err = max(k2_err, float((rows - p_rows).abs().max()),
                     float((d_rayt - p_rayt).abs().max()))
        require(torch.equal(out, p_out),
                f"K1 ({a[6].subs} sub-tiles, {a[6].stencil}) differs from "
                f"its twin")
        require(torch.equal(rows, p_rows) and torch.equal(d_rayt, p_rayt),
                f"K2 ({a[6].subs} sub-tiles, {a[6].stencil}) differs from "
                f"its twin")
        require(torch.equal(rows2, rows) and torch.equal(d_rayt2, d_rayt),
                "K2 differs between two runs")
    return k1_err, k2_err


def variant_times(torch, args, gss):
    """(K1 ms, K2 ms, K1 twin ms, K2 twin ms) over every group: the
    kernels after warm-up, the twins once."""
    from dvren_tpu_torch.ops import fused_tiles

    k1 = cuda_ms(torch, lambda: [fused_tiles.tile_forward(*a) for a in args],
                 10)
    k2 = cuda_ms(torch, lambda: [fused_tiles.tile_backward(*a[:6], gs, a[6])
                                 for a, gs in zip(args, gss)], 10)
    k1p = cuda_ms(torch, lambda: [fused_tiles.tile_forward_plain(*a)
                                  for a in args], 1, warmup=0)
    k2p = cuda_ms(torch, lambda: [fused_tiles.tile_backward_plain(
        *a[:6], gs, a[6]) for a, gs in zip(args, gss)], 1, warmup=0)
    return k1, k2, k1p, k2p


def variant_kernels(form, args, gss, sched, launches, errs, times) -> list:
    """The ``kernels`` entries of K1 and K2 in one form."""
    live = sched.tiled_samples
    extra = SUPER_OPS if sched.cell_scale == 2 else 0
    k1_in = sum(nbytes(*a[:6]) for a in args)
    out = sum(a[0].shape[0] * 5 * 256 * 4 for a in args)
    rows = sum(a[0].shape[0] * a[6].banks * 128 * a[6].cols * 4 for a in args)
    return [
        {"name": f"fused_tiles:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:656",
         "launches": launches[0], "max_abs_err": errs[0],
         "ms": times[0], "plain_ms": times[2],
         **bound(k1_in + out, live * (DENSE_FWD_OPS + extra))},
        {"name": f"fused_tiles_bwd:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:714",
         "launches": launches[1], "max_abs_err": errs[1],
         "ms": times[1], "plain_ms": times[3],
         **bound(k1_in + sum(nbytes(g) for g in gss) + rows,
                 live * (DENSE_BWD_OPS + extra))}]


def run_subtiles(torch, P, dev, card) -> tuple[list, dict]:
    """Phases 28-33: the sub-tiled and supercell schedules of the cascade,
    with K1 and K2 in their subs 4 / 16 and supercell forms: the fine-grid
    scene (float32: 16 px supercells; bfloat16: 8 px cells), the fit
    flagship's eight views (8 px supercells) and its view 0 at 4 px."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import tiled

    counts = functools.partial(launch_counts, fused_tiles, packed_transpose)
    reset = functools.partial(reset_counts, fused_tiles, packed_transpose)
    gen = torch.Generator(device=dev).manual_seed(28)
    kernels, report = [], {}

    def sgd_steps(plan, field_t, sched, lr):
        target = torch.zeros((plan.height, plan.width, 3), device=dev)
        opt = torch.optim.SGD(field_t.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled(plan, field_t, sched).image, target)
            loss.backward()
            opt.step()
            return loss

        return step

    def fine_phase(name, dtype, want_note):
        # 28 / 30. the fine-grid scene through Renderer.forward's cascade
        plan, config = headline_scene(P, grid_n=128, max_steps=256)
        field = P.DenseGridField.create(config, device=dev).with_packed_dtype(
            dtype).requires_grad_(False)
        renderer = P.Renderer(P.Context.create(device="cuda"), plan)
        reset()
        res = renderer.forward(field)
        c = counts()
        sched = renderer._tiled_schedule
        build_s = build_ms(res.stats.notes) / 1e3
        print(f"fine-grid {name} Renderer.forward: {res.stats.total_ms:.3f} "
              f"ms (schedule included), launches {c}; "
              f"{schedule_line(sched, build_s)}; notes {res.stats.notes}",
              flush=True)
        require(want_note in res.stats.notes and sched.fallback_rays == 0,
                f"the fine-grid {name} cascade did not land on {want_note}")
        require(c["fused_tiles"] == len(sched.groups) and c["packed_table"] == 0
                and c["packed_table16"] == (0 if dtype == "float32" else 1),
                f"the fine-grid {name} forward launched {c}")
        for key in ("image", "transmittance", "opacity", "depth"):
            require(bool(np.isfinite(getattr(res, key)).all()),
                    f"fine-grid {key} not finite")
        require(float(res.opacity.max()) > 0.0, "opacity is 0 everywhere")
        with torch.no_grad():
            t0 = time.perf_counter()
            plain = tiled.render_tiled(plan, field, sched, use_kernel=False)
            torch.cuda.synchronize()
            plain_frame_s = time.perf_counter() - t0
        err, depth, hit = planes_errors(res, plain)
        print(f"fine-grid {name} forward vs plain path: planes {err:.3e}, "
              f"depth {depth:.3e}, hitmask equal {hit} (plain frame "
              f"{plain_frame_s:.2f} s)", flush=True)
        require(err <= TOL and depth <= TOL_DEPTH and hit,
                f"the fine-grid {name} frame differs from the plain path")

        # 29 / 30. K1 and K2 in this form against their twins, first SUBSET
        # tiles of every group; backward deterministic; SGD steps
        args = variant_args(torch, plan, field, sched)
        errs = twins_bit_equal(torch, args, gen, SUBSET)
        print(f"fine-grid {name}: K1 and K2 == twins bit for bit on the "
              f"first {SUBSET} tiles of all {len(args)} groups; repeats "
              f"equal", flush=True)
        dl = (torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2
              - 1).cpu().numpy()
        torch.use_deterministic_algorithms(True)
        try:
            g1 = renderer.backward(field, dl)
            g2 = renderer.backward(field, dl)
        finally:
            torch.use_deterministic_algorithms(False)
        for key in ("sigma", "color", "camera", "camera_k"):
            x = getattr(g1, key)
            require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                    f"fine-grid backward {key} not finite or zero")
            require(np.array_equal(x, getattr(g2, key)),
                    f"fine-grid backward {key} differs between two calls")
        n_values = plan.height * plan.width * 3
        step = sgd_steps(plan, P.DenseGridField.create(
            config, device=dev).with_packed_dtype(dtype), sched,
            LR * n_values)
        reset()
        losses = [float(step().detach()) for _ in range(4)]
        step_c = counts()
        print(f"fine-grid {name}: 4 SGD steps at lr {LR} x {n_values}: loss "
              f"{losses}; launches {step_c}; two deterministic backwards "
              f"equal", flush=True)
        require(all(np.isfinite(losses))
                and all(b < a for a, b in zip(losses, losses[1:])),
                f"the fine-grid {name} loss does not fall")
        require(step_c["fused_tiles_bwd"] == 4 * len(sched.groups),
                "K2 did not launch per group in every step")

        # times
        with torch.no_grad():
            frame_ms = cuda_ms(torch, lambda: tiled.render_tiled(
                plan, field, sched), 10, warmup=2)
        step_ms = cuda_ms(torch, sgd_steps(plan, P.DenseGridField.create(
            config, device=dev).with_packed_dtype(dtype), sched, LR), 5,
            warmup=1)
        gss = [torch.randn((a[0].shape[0], 5, 16, 16), generator=gen,
                           device=dev) for a in args]
        times = variant_times(torch, args, gss)
        print(f"fine-grid {name} times ms [{card}]: frame {frame_ms:.4f} = "
              f"{plan.ray_count / frame_ms / 1e3:.3f} Mrays/s, SGD step "
              f"{step_ms:.4f}; K1 {times[0]:.4f} over {len(args)} launches "
              f"(plain {times[2]:.4f}), K2 {times[1]:.4f} (plain "
              f"{times[3]:.4f})", flush=True)
        form = (f"supercell_{sched.tile_px}px" if sched.cell_scale == 2
                else f"subtiled_{sched.tile_px}px")
        kernels.extend(variant_kernels(
            form, args, gss, sched, (c["fused_tiles"],
                                     step_c["fused_tiles_bwd"]), errs, times))
        report[f"finegrid_{name}"] = {
            "tile_px": sched.tile_px, "cell_scale": sched.cell_scale,
            "groups": len(sched.groups),
            "banks_max": max(g.banks for g in sched.groups),
            "live_samples": sched.tiled_samples, "build_s": build_s,
            "frame_ms": frame_ms, "step_ms": step_ms, "k1_ms": times[0],
            "k2_ms": times[1], "k1_plain_ms": times[2],
            "k2_plain_ms": times[3], "plain_frame_s": plain_frame_s,
            "vs_plain": err, "losses": losses}

    fine_phase("float32", "float32", "tiled_supercell_16px")
    fine_phase("bfloat16", "bfloat16", "tiled_subtiled_8px")

    # 31-32. the fit flagship: each view through the cascade, Adam steps
    # on the summed loss of the eight views, camera gradients on view 0
    plans, config = flagship_views(P)
    truth = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    scheds, targets, notes, builds = [], [], [], []
    t0 = time.perf_counter()
    reset()
    for pv in plans:
        r = P.Renderer(P.Context.create(device="cuda"), pv)
        res = r.forward(truth)
        scheds.append(r._tiled_schedule)
        builds.append(build_ms(res.stats.notes) / 1e3)
        notes.append([n for n in res.stats.notes if n.startswith("tiled_")
                      and "=" not in n])
        with torch.no_grad():
            targets.append(tiled.render_tiled(pv, truth, scheds[-1]).image)
    fwd_c = counts()
    fit_build_s = time.perf_counter() - t0
    n_groups = sum(len(s.groups) for s in scheds)
    print(f"fit flagship: {len(plans)} views through the cascade in "
          f"{fit_build_s:.3f} s (schedules and two frames each), notes "
          f"{notes}; launches {fwd_c}", flush=True)
    for v, (s, b) in enumerate(zip(scheds, builds)):
        print(f"  view {v}: {schedule_line(s, b)}", flush=True)
    require(all(s.tile_px == 8 and s.cell_scale == 2 and s.fallback_rays == 0
                for s in scheds),
            "a flagship view did not land on 8 px supercells without overflow")
    require(fwd_c["fused_tiles"] == 2 * n_groups and fwd_c["packed_table"] == 0,
            f"the flagship forwards launched {fwd_c}")
    fit_args = [a for pv, s in zip(plans, scheds)
                for a in variant_args(torch, pv, truth, s)]
    fit_errs = twins_bit_equal(torch, fit_args, gen)
    print(f"fit flagship: K1 and K2 (8 px supercells) == twins bit for bit "
          f"on all {len(fit_args)} groups of the {len(plans)} views",
          flush=True)

    student = P.DenseGridField.create(dataclasses.replace(
        config, sigma=np.full(len(config.sigma), 0.5, np.float32),
        color=np.full(len(config.color), 0.5, np.float32)), device=dev)
    opt = torch.optim.Adam(student.parameters(), lr=FIT_LR)

    def fit_step():
        opt.zero_grad(set_to_none=True)
        loss = sum(mse(tiled.render_tiled(pv, student, s).image, tg)
                   for pv, s, tg in zip(plans, scheds, targets))
        loss.backward()
        opt.step()
        return loss

    reset()
    fit_losses = [float(fit_step().detach()) for _ in range(FIT_ADAM_STEPS)]
    fit_c = counts()
    print(f"fit flagship: {FIT_ADAM_STEPS} Adam steps (lr {FIT_LR}) on the "
          f"summed loss of {len(plans)} views: loss {fit_losses}; launches "
          f"{fit_c}", flush=True)
    require(all(np.isfinite(fit_losses)) and fit_losses[-1] < fit_losses[0],
            "the flagship fit loss does not fall")
    require(fit_c["fused_tiles"] == FIT_ADAM_STEPS * n_groups
            and fit_c["fused_tiles_bwd"] == FIT_ADAM_STEPS * n_groups,
            f"the fit steps launched {fit_c}")
    fit_step_ms = cuda_ms(torch, fit_step, 5, warmup=1)

    def view0_grads(use_kernel, sched0):
        from dvren_tpu_torch.ops.raygen import camera_arrays

        k, c2w, _ = camera_arrays(plans[0], dev)
        k.requires_grad_(True)
        c2w.requires_grad_(True)
        leaf = student.with_params(student.sigma.detach().clone(),
                                   student.color.detach().clone())
        img = tiled.render_tiled(plans[0], leaf, sched0,
                                 use_kernel=use_kernel, k=k, c2w=c2w).image
        dl0 = torch.linspace(-1, 1, img.numel(), device=dev).reshape(img.shape)
        return torch.autograd.grad(torch.sum(img * dl0),
                                   (leaf.sigma, leaf.color, c2w, k))

    torch.use_deterministic_algorithms(True)
    try:
        cam_k = view0_grads(True, scheds[0])
        cam_k2 = view0_grads(True, scheds[0])
    finally:
        torch.use_deterministic_algorithms(False)
    cam_p = view0_grads(False, scheds[0])
    require(all(torch.equal(a, b) for a, b in zip(cam_k, cam_k2)),
            "view 0's gradients differ between two runs")
    require(float(cam_k[2].abs().max()) > 0.0, "view 0's d(c2w) is zero")
    cam_ok = all(torch.allclose(a, b, rtol=CAM_RTOL, atol=CAM_ATOL)
                 for a, b in zip(cam_k[2:], cam_p[2:]))
    grid_err = max(rel_err(a, b) for a, b in zip(cam_k[:2], cam_p[:2]))
    print(f"fit flagship view 0 camera gradients: d(c2w) max "
          f"{float(cam_k[2].abs().max()):.4e}, vs plain path "
          f"{float((cam_k[2] - cam_p[2]).abs().max()):.3e}; grids "
          f"{grid_err:.3e} x scale; two runs equal", flush=True)
    require(cam_ok and grid_err <= GRID_TOL,
            "view 0's gradients differ from the plain path")
    fit_gss = [torch.randn((a[0].shape[0], 5, 16, 16), generator=gen,
                           device=dev) for a in fit_args]
    fit_times = variant_times(torch, fit_args, fit_gss)
    with torch.no_grad():
        fit_frames_ms = cuda_ms(torch, lambda: [tiled.render_tiled(
            pv, student, s) for pv, s in zip(plans, scheds)], 10)
    print(f"fit flagship times ms [{card}]: {len(plans)} frames "
          f"{fit_frames_ms:.4f}, Adam step {fit_step_ms:.4f}; K1 "
          f"{fit_times[0]:.4f} over {len(fit_args)} launches (plain "
          f"{fit_times[2]:.4f}), K2 {fit_times[1]:.4f} (plain "
          f"{fit_times[3]:.4f})", flush=True)
    live = sum(s.tiled_samples for s in scheds)
    merged = dataclasses.replace(scheds[0], tiled_samples=live)
    kernels.extend(variant_kernels(
        "supercell_8px", fit_args, fit_gss, merged,
        (fit_c["fused_tiles"], fit_c["fused_tiles_bwd"]), fit_errs, fit_times))

    # 33. view 0 at 4 px: frame and backward
    t0 = time.perf_counter()
    s4 = tiled.build_tiled_schedule(plans[0], student, tile_px=4).to(dev)
    s4_s = time.perf_counter() - t0
    print(f"fit view 0 at 4 px: {schedule_line(s4, s4_s)}", flush=True)
    require(s4.fallback_rays == 0, "view 0 overflows at 4 px")
    reset()
    with torch.no_grad():
        f4 = tiled.render_tiled(plans[0], student, s4)
    leaf = student.with_params(student.sigma.detach().clone(),
                               student.color.detach().clone())
    img4 = tiled.render_tiled(plans[0], leaf, s4).image
    g4 = torch.autograd.grad(mse(img4, targets[0]), (leaf.sigma, leaf.color))
    c4 = counts()
    print(f"fit view 0 at 4 px: frame and backward launches {c4}", flush=True)
    require(c4["fused_tiles"] == 2 * len(s4.groups)
            and c4["fused_tiles_bwd"] == len(s4.groups)
            and c4["packed_table"] == 2 and c4["packed_table_bwd"] == 1,
            f"the 4 px frame and backward launched {c4}")
    with torch.no_grad():
        p4 = tiled.render_tiled(plans[0], student, s4, use_kernel=False)
    plain_leaf = student.with_params(student.sigma.detach().clone(),
                                     student.color.detach().clone())
    pg4 = torch.autograd.grad(
        mse(tiled.render_tiled(plans[0], plain_leaf, s4,
                               use_kernel=False).image, targets[0]),
        (plain_leaf.sigma, plain_leaf.color))
    e4 = max(float((getattr(f4, k) - getattr(p4, k)).abs().max())
             for k in ("image", "transmittance", "opacity"))
    ge4 = max(rel_err(a, b) for a, b in zip(g4, pg4))
    vs8 = float((f4.image - tiled.render_tiled(plans[0], student,
                                               scheds[0]).image.detach())
                .abs().max())
    print(f"fit view 0 at 4 px vs plain path: planes {e4:.3e}, grids "
          f"{ge4:.3e} x scale; vs the 8 px supercell frame {vs8:.3e}",
          flush=True)
    require(e4 <= TOL and ge4 <= GRID_TOL,
            "the 4 px frame or backward differs from the plain path")
    require(vs8 == 0.0, "the 4 px frame differs from the 8 px supercell one")
    args4 = variant_args(torch, plans[0], student, s4)
    errs4 = twins_bit_equal(torch, args4, gen)
    gss4 = [torch.randn((a[0].shape[0], 5, 16, 16), generator=gen,
                        device=dev) for a in args4]
    times4 = variant_times(torch, args4, gss4)
    with torch.no_grad():
        frame4_ms = cuda_ms(torch, lambda: tiled.render_tiled(
            plans[0], student, s4), 20)

    def bwd4():
        lf = student.with_params(student.sigma.detach().clone(),
                                 student.color.detach().clone())
        mse(tiled.render_tiled(plans[0], lf, s4).image,
            targets[0]).backward()

    torch.use_deterministic_algorithms(True)
    try:
        g4a = view0_grads(True, s4)
        g4b = view0_grads(True, s4)
    finally:
        torch.use_deterministic_algorithms(False)
    require(all(torch.equal(a, b) for a, b in zip(g4a, g4b)),
            "view 0's 4 px backward differs between two runs")
    bwd4_ms = cuda_ms(torch, bwd4, 10)
    print(f"fit view 0 at 4 px times ms [{card}]: frame {frame4_ms:.4f}, "
          f"forward + backward {bwd4_ms:.4f}; K1 {times4[0]:.4f} over "
          f"{len(args4)} launches (plain {times4[2]:.4f}), K2 "
          f"{times4[1]:.4f} (plain {times4[3]:.4f}); K1 and K2 == twins bit "
          f"for bit on every group; two deterministic backwards equal",
          flush=True)
    kernels.extend(variant_kernels(
        "subtiled_4px", args4, gss4, s4,
        (c4["fused_tiles"], c4["fused_tiles_bwd"]), errs4, times4))
    report["fit_flagship"] = {
        "views": len(plans), "notes": notes,
        "groups": [len(s.groups) for s in scheds],
        "banks_max": [max(g.banks for g in s.groups) for s in scheds],
        "live_samples": [s.tiled_samples for s in scheds],
        "cascade_and_frames_s": fit_build_s, "build_s": builds,
        "losses": fit_losses,
        "adam_step_ms": fit_step_ms, "frames_ms": fit_frames_ms,
        "k1_ms": fit_times[0], "k2_ms": fit_times[1],
        "k1_plain_ms": fit_times[2], "k2_plain_ms": fit_times[3],
        "view0_dc2w_vs_plain": float((cam_k[2] - cam_p[2]).abs().max()),
        "px4": {"groups": len(s4.groups), "build_s": s4_s,
                "frame_ms": frame4_ms, "fwd_bwd_ms": bwd4_ms,
                "k1_ms": times4[0], "k2_ms": times4[1],
                "k1_plain_ms": times4[2], "k2_plain_ms": times4[3]}}
    return kernels, report


GRID_VIEW_LR = 8e-3      # the grid path's Adam rate (phase 19's)
GRID_VIEW_BANKS = 77     # the widest 4 px tile of the finest-64 views
FLAGSHIP_STEPS = 300     # fit_dense_grid's step cap at the flagship
FLAGSHIP_PSNR = 35.0     # tools/fit_benchmark.py's target
FLAGSHIP_SYNC = 32       # tools/fit_benchmark.py's sync_every


def grid_view_spec(finest: int) -> dict:
    """tools/hashmlp_bench.py's grid spec on a four-level ladder ending at
    ``finest`` (32: the spec as it is; 64: the finest grid_path_ok admits)."""
    res = tuple(finest >> (3 - i) for i in range(4))
    return dict(GRID_SPEC, resolutions=res, base_resolution=float(res[0]),
                finest_resolution=float(finest))


def grid_group_args(torch, plan, spec, sched, params, subs) -> list:
    """Every group's K8f arguments for ``sched`` and detached ``params``."""
    from dvren_tpu_torch.ops import hash_grid, hash_tiles
    from dvren_tpu_torch.render import tiled

    table = hash_grid.build_hash_grid_table(params, spec)
    tabs = tiled._gather_bank_tables(table, sched.gathermap_all,
                                     [(g.n_tiles, g.banks)
                                      for g in sched.groups])
    sc = hash_tiles.pack_mlp_scalars(params, spec)
    return [(tabs[i], g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1),
             sc, hash_grid.grid_op_params(plan, spec, g.banks, g.n_chunks,
                                          subs))
            for i, g in enumerate(sched.groups)]


def run_grid_views(torch, P, dev, card, finest) -> tuple[list, dict]:
    """Phase 34 (finest 32: 8 px sub-tiles, K8 at subs 4) or 35 (finest 64:
    4 px, subs 16): the hash grid path over the fit flagship's eight 96^2
    views, each through ``build_hash_grid_schedule``'s cascade."""
    from dvren_tpu_torch.ops import hash_grid
    from dvren_tpu_torch.opt.fit import mse
    from dvren_tpu_torch.render import hash_tiled

    want_px = {32: 8, 64: 4}[finest]
    subs = (16 // want_px) ** 2
    form = f"subs{subs}"
    name = f"grid views (finest {finest}, {want_px} px)"
    plans, _ = flagship_views(P)
    spec = P.HashMLPSpec(**grid_view_spec(finest))
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                       spec=spec, device=dev)
    field.requires_grad_(False)
    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(2),
                                         spec=spec, table_std=1.0, device=dev)
    teacher.requires_grad_(False)

    # the cascade, view by view; the gathered tables reckoned before K8f
    scheds, builds = [], []
    for pv in plans:
        t0 = time.perf_counter()
        host = hash_tiled.build_hash_grid_schedule(pv, field)
        builds.append(time.perf_counter() - t0)
        scheds.append(host.to(dev))
    for v, (s, b) in enumerate(zip(scheds, builds)):
        print(f"{name}, view {v}: {schedule_line(s, b)}", flush=True)
    require(all(s.tile_px == want_px and s.fallback_rays == 0 for s in scheds),
            f"a {name} schedule is not {want_px} px without overflow")
    banks = max(g.banks for s in scheds for g in s.groups)
    require(finest == 32 or banks <= GRID_VIEW_BANKS,
            f"a {name} tile holds {banks} banks")
    cols = hash_grid.packed_cols(spec)
    table_gb = [sum(g.n_tiles * g.banks for g in s.groups) * cols * 128 * 4
                / 1e9 for s in scheds]
    print(f"{name}: gathered bank tables {min(table_gb):.3f}-"
          f"{max(table_gb):.3f} GB per view ({cols} columns)", flush=True)
    n_groups = sum(len(s.groups) for s in scheds)

    # K8f against its twin on every group (bit for bit), K8b on
    # GRID_SUBSET tiles of each (2e-5 x scale) and its repeat
    params = {k: v.detach() for k, v in field.params.items()}
    args = [a for pv, s in zip(plans, scheds)
            for a in grid_group_args(torch, pv, spec, s, params, subs)]
    gen = torch.Generator(device=dev).manual_seed(finest)
    gss = [torch.randn((a[0].shape[0], 5, 16, 16), generator=gen, device=dev)
           for a in args]
    # each twin runs once, timed: that run is both the reference of the
    # check and the kernels line's plain_ms
    outs = [hash_grid.hash_grid_forward(*a) for a in args]
    bwds = [hash_grid.hash_grid_backward(*a[:7], gs, a[7])
            for a, gs in zip(args, gss)]
    again = [hash_grid.hash_grid_backward(*a[:7], gs, a[7])
             for a, gs in zip(args, gss)]
    plains, k8f_plain_ms = timed_once(torch, lambda: [
        hash_grid.hash_grid_forward_plain(*a) for a in args])
    p_bwds, k8b_plain_ms = timed_once(torch, lambda: [
        hash_grid.hash_grid_backward_plain(*a[:7], gs, a[7])
        for a, gs in zip(args, gss)])
    f_err = b_rows = b_mlp = b_raw = 0.0
    for out, plain, (d_rows, d_sc), rep, (p_rows, p_sc) in zip(
            outs, plains, bwds, again, p_bwds):
        require(bool(torch.isfinite(out).all() and torch.isfinite(d_rows).all()
                     and torch.isfinite(d_sc).all()),
                f"K8f / K8b ({form}) not finite")
        f_err = max(f_err, float((out - plain).abs().max()))
        require(torch.equal(out, plain), f"K8f ({form}) differs from its twin")
        require(torch.equal(rep[0], d_rows) and torch.equal(rep[1], d_sc),
                f"K8b ({form}) differs between two runs")
        b_rows = max(b_rows, rel_err(d_rows, p_rows))
        b_mlp = max(b_mlp, rel_err(d_sc, p_sc))
        b_raw = max(b_raw, float((d_rows - p_rows).abs().max()),
                    float((d_sc - p_sc).abs().max()))
    del outs, plains, bwds, again, p_bwds
    print(f"{name}: K8f ({form}) == twin bit for bit on all {n_groups} groups "
          f"of the {len(plans)} views; K8b vs twin on every tile: slot rows "
          f"{b_rows:.3e}, d(MLP) {b_mlp:.3e} x scale (max |diff| "
          f"{b_raw:.3e}); repeats equal", flush=True)
    require(b_rows <= HASH_GRAD_TOL and b_mlp <= HASH_GRAD_TOL,
            f"K8b ({form}) differs from its twin beyond tolerance")

    # render_hash_grid_tiled against the plain path on view 0 (the twin
    # has matched K8f on every group above)
    with torch.no_grad():
        out = hash_tiled.render_hash_grid_tiled(plans[0], field, scheds[0])
        plain = hash_tiled.render_hash_grid_tiled(plans[0], field, scheds[0],
                                                  use_kernel=False)
        frame_err, frame_depth, hit = image_errors(out, plain)
        require(all(bool(torch.isfinite(getattr(out, k)).all())
                    for k in ("image", "opacity", "depth"))
                and float(out.opacity.max()) > 0.0 and hit,
                f"the {name} frame is not finite or empty")
        targets = [hash_tiled.render_hash_grid_tiled(pv, teacher, s).image
                   for pv, s in zip(plans, scheds)]
    print(f"{name}: render_hash_grid_tiled vs plain path on view 0: planes "
          f"{frame_err:.3e}, depth {frame_depth:.3e}", flush=True)
    require(frame_err <= TOL and frame_depth <= TOL_DEPTH,
            f"the {name} frame differs from the plain path")

    # the main path: Adam steps on the summed loss of the views
    student = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, device=dev)
    opt = torch.optim.Adam(student.parameters(), lr=GRID_VIEW_LR)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = sum(mse(hash_tiled.render_hash_grid_tiled(pv, student, s).image,
                       tg) for pv, s, tg in zip(plans, scheds, targets))
        loss.backward()
        opt.step()
        return loss

    reset_grid_counts(hash_grid)
    losses = []
    for _ in range(GRID_STEPS):
        before = grid_counts(hash_grid)
        losses.append(float(step().detach()))
        after = grid_counts(hash_grid)
        require(all(after[k] - before[k] == n_groups for k in after),
                f"K8f / K8b did not launch once per group in a {name} step: "
                f"{before} -> {after}")
    launches = grid_counts(hash_grid)
    print(f"{name}: {GRID_STEPS} Adam steps (lr {GRID_VIEW_LR}) on the summed "
          f"loss of {len(plans)} views: loss {losses[0]:.6e} -> "
          f"{losses[-1]:.6e}; launches {launches}", flush=True)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"the {name} loss does not fall")

    # times: kernels after warm-up (the twins' above)
    step_ms = cuda_ms(torch, step, 5, warmup=1)
    with torch.no_grad():
        frames_ms = cuda_ms(torch, lambda: [hash_tiled.render_hash_grid_tiled(
            pv, field, s) for pv, s in zip(plans, scheds)], 10)
    k8f_ms = cuda_ms(torch, lambda: [hash_grid.hash_grid_forward(*a)
                                     for a in args], 10)
    k8b_ms = cuda_ms(torch, lambda: [hash_grid.hash_grid_backward(
        *a[:7], gs, a[7]) for a, gs in zip(args, gss)], 5, warmup=1)
    print(f"{name} times ms [{card}]: {len(plans)} frames {frames_ms:.4f}, "
          f"Adam step {step_ms:.4f}; K8f {k8f_ms:.4f} over {n_groups} "
          f"launches (plain {k8f_plain_ms:.4f}), K8b {k8b_ms:.4f} (plain "
          f"{k8b_plain_ms:.4f})", flush=True)

    live = sum(s.tiled_samples for s in scheds)
    f_in = sum(nbytes(*a[:7]) for a in args)
    f_out = sum(a[0].shape[0] * 5 * 256 * 4 for a in args)
    rows = sum(a[0].shape[0] * a[7].banks * 128 * cols * 4 for a in args)
    b_bytes = f_in + sum(nbytes(g) for g in gss) + rows + 4 * len(args[0][6])
    kernels = [
        {"name": f"hash_grid:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:223",
         "launches": launches["hash_grid"], "max_abs_err": f_err,
         "ms": k8f_ms, "plain_ms": k8f_plain_ms,
         **bound(f_in + f_out, live * k8f_ops(spec))},
        {"name": f"hash_grid_bwd:{form}", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/hash_grid_bwd.cu",
         "replaces": "dvren_tpu/ops/hash_grid.py:282",
         "launches": launches["hash_grid_bwd"], "max_abs_err": b_raw,
         "ms": k8b_ms, "plain_ms": k8b_plain_ms,
         **bound(b_bytes, live * k8b_ops(spec))}]
    report = {
        "tile_px": want_px, "groups": [len(s.groups) for s in scheds],
        "tiles": [sum(g.n_tiles for g in s.groups) for s in scheds],
        "banks_max": banks, "live_samples": live, "build_s": builds,
        "table_gb": table_gb, "frames_ms": frames_ms, "step_ms": step_ms,
        "k8f_ms": k8f_ms, "k8b_ms": k8b_ms, "k8f_plain_ms": k8f_plain_ms,
        "k8b_plain_ms": k8b_plain_ms, "losses": losses,
        "k8b_rel_err": [b_rows, b_mlp]}
    return kernels, report


def run_fit_flagship(torch, P, dev, card,
                     per_view_step_ms) -> tuple[list, dict]:
    """Phase 36: ``fit_dense_grid`` at the fit flagship
    (tools/fit_benchmark.py's scene, cameras and settings): the views
    merged into one schedule, K1 and K2 once per step; its Adam step
    beside ``per_view_step_ms``, phase 32's with a schedule per view."""
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import tiled

    counts = functools.partial(launch_counts, fused_tiles, packed_transpose)
    reset = functools.partial(reset_counts, fused_tiles, packed_transpose)
    plans, config = flagship_views(P)
    truth = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    cams = [P.CameraConfig(c2w=pv.camera.c2w) for pv in plans]
    # the targets: phase 31's frames, each view through its own cascade
    frames = []
    for pv in plans:
        s, _ = tiled.build_tiled_schedule_auto(pv, truth)
        with torch.no_grad():
            frames.append(tiled.render_tiled(pv, truth, s.to(dev)).image)
    targets = torch.stack(frames)
    init = truth.with_params(torch.full_like(truth.sigma, 0.5),
                             torch.full_like(truth.color, 0.5))

    t0 = time.perf_counter()
    views = fit._scheduled_views(plans[0], cams, init, "tiled")
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merged, render_stack = views[1], views[2]
    sched = merged.sched
    shapes = [(g.n_chunks, g.n_tiles, g.banks) for g in sched.groups]
    print(f"fit flagship merged: {schedule_line(sched, merge_s)} (eight "
          f"builds, the merge and one upload); (n_chunks, n_tiles, banks) "
          f"{shapes}", flush=True)
    require(len(shapes) == 1 and sched.tile_px == 8 and sched.cell_scale == 2
            and sched.fallback_rays == 0,
            "the flagship's views did not merge into one 8 px supercell group")
    with torch.no_grad():
        stack = render_stack(truth, merged)
    stack_err = float((stack - targets).abs().max())
    print(f"fit flagship: render_tiled_stack vs the per-view frames "
          f"{stack_err:.3e}", flush=True)
    require(stack_err <= TOL, "the stack differs from the per-view frames")
    gen = torch.Generator(device=dev).manual_seed(36)
    args = variant_args(torch, plans[0], truth, sched)
    errs = twins_bit_equal(torch, args, gen, SUBSET)
    print(f"fit flagship merged group: K1 and K2 == twins bit for bit on its "
          f"first {SUBSET} tiles; repeats equal", flush=True)

    # the main path: fit_dense_grid in its auto mode
    cfg = fit.FitConfig(learning_rate=FIT_LR, steps=FLAGSHIP_STEPS,
                        target_psnr=FLAGSHIP_PSNR, log_every=100,
                        sync_every=FLAGSHIP_SYNC)
    reset()
    res = fit.fit_dense_grid(plans[0], init, cams, targets, cfg)
    c = counts()
    reached = next((i + 1 for i, p in enumerate(res.psnr_history)
                    if p >= FLAGSHIP_PSNR), None)
    print(f"fit_dense_grid at the flagship: mode {res.mode}, {res.steps_run} "
          f"steps, PSNR {res.psnr_history[0]:.4f} -> "
          f"{res.psnr_history[-1]:.4f} dB, PSNR {FLAGSHIP_PSNR} first at step "
          f"{reached} (checked every {FLAGSHIP_SYNC}), reached "
          f"{res.reached_target}; schedule_build_s {res.schedule_build_s:.4f}, "
          f"first_step_s {res.first_step_s:.4f}, steady_step_ms "
          f"{res.steady_step_ms:.4f}, wall_clock_s {res.wall_clock_s:.4f}; "
          f"launches {c}", flush=True)
    require(res.mode == "tiled", f"the auto mode chose {res.mode}")
    require(c["fused_tiles"] == res.steps_run
            and c["fused_tiles_bwd"] == res.steps_run
            and c["packed_table"] == 0 and c["packed_table_bwd"] == 0,
            f"the fit did not launch K1 and K2 once per step: {c}")
    require(all(np.isfinite(res.loss_history))
            and res.loss_history[-1] < res.loss_history[0],
            "the flagship fit loss does not fall")
    require(float(res.field.sigma.min()) >= 0.0
            and float(res.field.color.max()) <= 1.0,
            "the fitted grid left the projection's bounds")

    # times: the Adam step with CUDA events; K1 and K2 at the merged group
    student = init.with_params(init.sigma.detach().clone(),
                               init.color.detach().clone())
    opt = torch.optim.Adam(student.parameters(), lr=FIT_LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = fit.make_train_step_scheduled(plans[0], cams, student, opt,
                                         views=views)
    step_ms = cuda_ms(torch, lambda: step(student, targets), 10, warmup=2)
    gss = [torch.randn((a[0].shape[0], 5, 16, 16), generator=gen, device=dev)
           for a in args]
    times = variant_times(torch, args, gss)
    with torch.no_grad():
        stack_ms = cuda_ms(torch, lambda: render_stack(student, merged), 10)
    print(f"fit flagship times ms [{card}]: Adam step {step_ms:.4f} (each "
          f"view its own schedule: {per_view_step_ms:.4f}), {len(plans)}-view "
          f"stack {stack_ms:.4f}; K1 {times[0]:.4f} (plain {times[2]:.4f}), "
          f"K2 {times[1]:.4f} (plain {times[3]:.4f}), one launch each",
          flush=True)
    kernels = variant_kernels(
        "merged_supercell_8px", args, gss, sched,
        (c["fused_tiles"], c["fused_tiles_bwd"]), errs, times)
    report = {
        "mode": res.mode, "shape": shapes, "merge_s": merge_s,
        "stack_vs_frames": stack_err, "steps_run": res.steps_run,
        "psnr_first": res.psnr_history[0], "psnr_last": res.psnr_history[-1],
        "psnr_target_step": reached, "reached": res.reached_target,
        "schedule_build_s": res.schedule_build_s,
        "first_step_s": res.first_step_s,
        "steady_step_ms": res.steady_step_ms,
        "wall_clock_s": res.wall_clock_s, "adam_step_ms": step_ms,
        "stack_ms": stack_ms, "k1_ms": times[0], "k2_ms": times[1],
        "k1_plain_ms": times[2], "k2_plain_ms": times[3]}
    return kernels, report


def run(only: str = "all") -> dict:
    import torch

    import dvren_tpu_torch as P
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import fused_tiles, gather_plan, packed_transpose
    from dvren_tpu_torch.render import tiled

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {}
    t_start = time.perf_counter()

    def elapsed(phases):
        print(f"phases {phases} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # 1. card and build
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_build.build_seconds} s)", flush=True)
    for line in _build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if only == "grid":
        grid_kernels, grid_report = run_grid(torch, P, dev)
        print(json.dumps({"kernels": grid_kernels}), flush=True)
        print(json.dumps({**grid_report, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device

    # 2. K3 against its plain twin at 64^3
    plan, config = headline_scene(P)
    field = P.DenseGridField.create(config, device=dev).requires_grad_(False)
    sigma, color = field.sigma, field.color
    rows_k = packed_transpose.build_rows(sigma, color)
    rows_p = packed_transpose.build_rows_plain(sigma, color)
    torch.cuda.synchronize()
    require(torch.equal(rows_k, rows_p), "K3 differs from its plain twin")
    print(f"K3 == plain, bit for bit: {tuple(rows_k.shape)}", flush=True)

    # 3. the headline schedule
    t0 = time.perf_counter()
    sched_host, _ = tiled.build_tiled_schedule_auto(plan, field)
    build_s = time.perf_counter() - t0
    sched = sched_host.to(dev)
    n_tiles = sum(g.n_tiles for g in sched.groups)
    print(f"schedule build {build_s:.3f} s: {len(sched.groups)} groups, "
          f"{n_tiles} tiles, chunks "
          f"{sorted({g.n_chunks for g in sched.groups})}, banks <= "
          f"{max(g.banks for g in sched.groups)}, "
          f"{sched.tiled_samples} of {sched.full_lattice_samples} samples "
          f"live, fallback_rays {sched.fallback_rays}", flush=True)
    require(sched.fallback_rays == 0, "schedule has fallback rays")
    report["schedule_build_s"] = build_s

    # 4. K1 against its plain twin on every group
    geom = (sched.bbox[0], sched.bbox[1], sched.grid_shape)
    shapes = [(g.n_tiles, g.banks) for g in sched.groups]
    tabs = tiled._gather_bank_tables(rows_k, sched.gathermap_all, shapes)
    params = [fused_tiles.tile_op_params(plan, geom, g.banks, g.n_chunks)
              for g in sched.groups]
    args = [(tabs[i], g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1),
             params[i]) for i, g in enumerate(sched.groups)]
    k1_err = k1_depth = k1_raw = 0.0
    for a in args:
        out_k = fused_tiles.tile_forward(*a)
        out_p = fused_tiles.tile_forward_plain(*a)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(out_k).all()), "K1 output not finite")
        err, depth = head_errors(torch, fused_tiles, plan, out_k, out_p)
        k1_err, k1_depth = max(k1_err, err), max(k1_depth, depth)
        k1_raw = max(k1_raw, float((out_k - out_p).abs().max()))
    print(f"K1 vs plain over {len(args)} groups: heads {k1_err:.3e}, "
          f"depth {k1_depth:.3e}, raw {k1_raw:.3e}", flush=True)
    require(k1_err <= TOL and k1_depth <= TOL_DEPTH,
            "K1 differs from its plain twin beyond tolerance")

    # 5. the main path, end to end
    renderer = P.Renderer(P.Context.create(device="cuda"), plan)
    fused_tiles.tile_forward.launches = 0
    packed_transpose.build_rows.launches = 0
    result = renderer.forward(field)
    launches = {"fused_tiles": fused_tiles.tile_forward.launches,
                "packed_table": packed_transpose.build_rows.launches}
    print(f"Renderer.forward: {result.stats.total_ms:.3f} ms (schedule "
          f"included), launches {launches}, notes {result.stats.notes}",
          flush=True)
    require(launches["fused_tiles"] > 0 and launches["packed_table"] > 0,
            "the main path did not launch both kernels")
    n_px = plan.width * plan.height
    require(result.image.shape == (n_px * 3,)
            and result.opacity.shape == (n_px,), "unexpected plane shapes")
    for name in ("image", "transmittance", "opacity", "depth"):
        require(bool(np.isfinite(getattr(result, name)).all()),
                f"{name} not finite")
    require(float(result.opacity.max()) > 0.0, "opacity is 0 everywhere")
    with torch.no_grad():
        plain = tiled.render_tiled(plan, field, renderer._tiled_schedule,
                                   use_kernel=False)
    e2e_err, e2e_depth, hit_ok = planes_errors(result, plain)
    print(f"forward vs plain path: planes {e2e_err:.3e}, depth "
          f"{e2e_depth:.3e}, hitmask equal {hit_ok}; opacity max "
          f"{float(result.opacity.max()):.6f} mean "
          f"{float(result.opacity.mean()):.6f}", flush=True)
    require(e2e_err <= TOL and e2e_depth <= TOL_DEPTH and hit_ok,
            "forward differs from the plain path")

    s_plan, s_config = small_scene(P)
    s_field = P.DenseGridField.create(s_config, device=dev)
    s_out = P.Renderer(P.Context.create(device="cuda"), s_plan).forward(
        s_field)
    cpu_field = P.DenseGridField.create(s_config, device="cpu")
    s_ref = P.Renderer(P.Context.create(device="cpu"), s_plan,
                       P.RenderOptions(use_tiles=True)).forward(cpu_field)
    s_err = max(float(np.abs(getattr(s_out, k) - getattr(s_ref, k)).max())
                for k in ("image", "transmittance", "opacity"))
    s_depth = float(np.abs(s_out.depth - s_ref.depth).max())
    print(f"small scene, card vs CPU plain: planes {s_err:.3e}, depth "
          f"{s_depth:.3e}", flush=True)
    require(s_err <= TOL and s_depth <= TOL_DEPTH
            and np.array_equal(s_out.hitmask, s_ref.hitmask),
            "small scene on the card differs from the CPU")

    # 6. times
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: tiled.render_tiled(plan, field, sched),
                         FRAMES, warmup=3)
        plain_fwd_ms = cuda_ms(
            torch, lambda: tiled.render_tiled(plan, field, sched,
                                              use_kernel=False), 3, warmup=1)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        renderer.forward(field)
    host_ms = (time.perf_counter() - t0) / FRAMES * 1e3
    n_rays = plan.ray_count
    print(f"forward {fwd_ms:.4f} ms/frame = {n_rays / fwd_ms / 1e3:.3f} "
          f"Mrays/s over {FRAMES} frames (plain path {plain_fwd_ms:.4f} "
          f"ms); Renderer.forward with host copies {host_ms:.4f} ms/frame; "
          f"peak device memory {peak_mb:.1f} MiB", flush=True)

    k3_ms = cuda_ms(torch, lambda: packed_transpose.build_rows(sigma, color),
                    50)
    k3_plain_ms = cuda_ms(
        torch, lambda: packed_transpose.build_rows_plain(sigma, color), 50)
    gather_ms = cuda_ms(
        torch, lambda: tiled._gather_bank_tables(
            rows_k, sched.gathermap_all, shapes), 20)
    k1_ms = cuda_ms(torch, lambda: [fused_tiles.tile_forward(*a)
                                    for a in args], 20)
    k1_plain_ms = cuda_ms(torch, lambda: [fused_tiles.tile_forward_plain(*a)
                                          for a in args], 3, warmup=1)
    raws = [fused_tiles.tile_forward(*a) for a in args]
    ids = [g.tile_ids for g in sched.groups]
    compose_ms = cuda_ms(torch, lambda: tiled._compose_tiles(plan, raws, ids),
                         20)
    print(f"stages ms/frame: K3 {k3_ms:.4f} (plain {k3_plain_ms:.4f}), "
          f"bank gather {gather_ms:.4f}, K1 {k1_ms:.4f} over "
          f"{len(args)} launches (plain {k1_plain_ms:.4f}), compose "
          f"{compose_ms:.4f}", flush=True)

    # 7. K2 against its plain twin on every group
    gen = torch.Generator(device=dev).manual_seed(7)
    gss = [torch.randn((g.n_tiles, 5, 16, 16), generator=gen, device=dev)
           for g in sched.groups]
    k2_err = k2_cam_err = k2_raw = 0.0
    k2_rows = []
    for a, gs in zip(args, gss):
        b_rows, b_rayt = fused_tiles.tile_backward(*a[:6], gs, a[6], cam=True)
        b_rows_nc, none = fused_tiles.tile_backward(*a[:6], gs, a[6])
        b_rows2, b_rayt2 = fused_tiles.tile_backward(*a[:6], gs, a[6],
                                                     cam=True)
        torch.cuda.synchronize()
        p_rows, p_rayt = fused_tiles.tile_backward_plain(*a[:6], gs, a[6],
                                                         cam=True)
        require(bool(torch.isfinite(b_rows).all()
                     and torch.isfinite(b_rayt).all()), "K2 not finite")
        require(none is None and torch.equal(b_rows_nc, b_rows),
                "K2 without the camera differs from K2 with it")
        require(torch.equal(b_rows2, b_rows) and torch.equal(b_rayt2, b_rayt),
                "K2 differs between two runs")
        k2_err = max(k2_err, rel_err(b_rows, p_rows))
        k2_cam_err = max(k2_cam_err, rel_err(b_rayt, p_rayt))
        k2_raw = max(k2_raw, float((b_rows - p_rows).abs().max()))
        k2_rows.append(b_rows.reshape(-1, 32))
    print(f"K2 vs plain over {len(args)} groups: d(table) {k2_err:.3e} x "
          f"scale (max |diff| {k2_raw:.3e}), d(rayt) {k2_cam_err:.3e} x "
          f"scale; repeat runs equal", flush=True)
    require(k2_err <= GRID_TOL and k2_cam_err <= RAYT_TOL,
            "K2 differs from its plain twin beyond tolerance")

    # 8. K4 against its plain twin at 64^3
    n_rows = packed_transpose.fullpitch_rows(sigma.shape)
    all_rows = torch.cat(k2_rows)
    tg = gather_plan.slot_rows_to_table(all_rows, sched.gather_plan, n_rows)
    k4_out = packed_transpose.table_grad_to_params(tg, sigma.shape)
    torch.cuda.synchronize()
    k4_plain = packed_transpose.table_grad_to_params_plain(tg, sigma.shape)
    require(all(torch.equal(x, y) for x, y in zip(k4_out, k4_plain)),
            "K4 differs from its plain twin")
    k4_err = max(float((x - y).abs().max()) for x, y in zip(k4_out, k4_plain))
    print(f"K4 == plain, bit for bit: d_sigma {tuple(k4_out[0].shape)}, "
          f"d_color {tuple(k4_out[1].shape)}", flush=True)

    # 9. Renderer.backward, deterministic
    dl = torch.rand((plan.ray_count, 3), generator=gen, device=dev) * 2 - 1
    dl = dl.cpu().numpy()
    reset_counts(fused_tiles, packed_transpose)
    torch.use_deterministic_algorithms(True)
    try:
        bwd = renderer.backward(field, dl)
        bwd_launches = launch_counts(fused_tiles, packed_transpose)
        bwd2 = renderer.backward(field, dl)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"Renderer.backward launches {bwd_launches}", flush=True)
    require(bwd_launches["fused_tiles_bwd"] == len(sched.groups)
            and bwd_launches["packed_table_bwd"] == 1,
            "Renderer.backward did not launch K2 per group and K4 once")
    for name in ("sigma", "color", "camera", "camera_k"):
        x = getattr(bwd, name)
        require(bool(np.isfinite(x).all()) and float(np.abs(x).max()) > 0,
                f"backward {name} not finite or zero")
        require(np.array_equal(x, getattr(bwd2, name)),
                f"backward {name} differs between two calls")
    dl_img = renderer._dl_image(dl)
    plain_g = [g.cpu().numpy() for g in tiled_grads(
        torch, P, tiled, plan, field, sched, dl_img, use_kernel=False)]
    bwd_errs = {
        "sigma": rel_err(torch.from_numpy(bwd.sigma),
                         torch.from_numpy(plain_g[0].reshape(-1))),
        "color": rel_err(torch.from_numpy(bwd.color),
                         torch.from_numpy(plain_g[1].reshape(-1)))}
    cam_ok = (np.allclose(bwd.camera, plain_g[2], rtol=CAM_RTOL,
                          atol=CAM_ATOL)
              and np.allclose(bwd.camera_k, plain_g[3], rtol=CAM_RTOL,
                              atol=CAM_ATOL))
    print(f"backward vs plain path: sigma {bwd_errs['sigma']:.3e} x scale, "
          f"color {bwd_errs['color']:.3e} x scale, camera "
          f"{float(np.abs(bwd.camera - plain_g[2]).max()):.3e}, camera_k "
          f"{float(np.abs(bwd.camera_k - plain_g[3]).max()):.3e}; two "
          f"calls equal", flush=True)
    require(max(bwd_errs.values()) <= GRID_TOL and cam_ok,
            "backward differs from the plain path")

    s_dl = np.random.default_rng(3).uniform(
        -1, 1, s_plan.ray_count * 3).astype(np.float32)
    s_card = P.Renderer(P.Context.create(device="cuda"), s_plan)
    s_card.forward(s_field)
    s_got = s_card.backward(s_field, s_dl)
    s_cpu = P.Renderer(P.Context.create(device="cpu"), s_plan,
                       P.RenderOptions(use_tiles=True))
    s_cpu.forward(cpu_field)
    s_want = s_cpu.backward(cpu_field, s_dl)
    s_bwd_err = max(rel_err(torch.from_numpy(getattr(s_got, k)),
                            torch.from_numpy(getattr(s_want, k)))
                    for k in ("sigma", "color"))
    print(f"small scene backward, card vs CPU: grids {s_bwd_err:.3e} x "
          f"scale, camera {float(np.abs(s_got.camera - s_want.camera).max()):.3e}",
          flush=True)
    require(s_bwd_err <= GRID_TOL
            and np.allclose(s_got.camera, s_want.camera, rtol=CAM_RTOL,
                            atol=CAM_ATOL)
            and np.allclose(s_got.camera_k, s_want.camera_k, rtol=CAM_RTOL,
                            atol=CAM_ATOL),
            "small scene backward on the card differs from the CPU")

    # 10. training steps through autograd of render_tiled
    from dvren_tpu_torch.opt.fit import mse, psnr

    target = torch.zeros((plan.height, plan.width, 3), device=dev)

    def trainer(lr):
        field_t = P.DenseGridField.create(config, device=dev)
        opt = torch.optim.SGD(field_t.parameters(), lr=lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = mse(tiled.render_tiled(plan, field_t, sched).image,
                       target)
            loss.backward()
            opt.step()
            return loss

        return field_t, step

    def four_steps(lr):
        field_t, step = trainer(lr)
        losses = []
        for _ in range(4):
            before = launch_counts(fused_tiles, packed_transpose)
            losses.append(float(step().detach()))
            after = launch_counts(fused_tiles, packed_transpose)
            require(all(after[k] > before[k] for k in DENSE_F32),
                    f"a kernel did not launch in a training step: {after}")
        moved = max(float((field_t.sigma.detach() - sigma).abs().max()),
                    float((field_t.color.detach() - color).abs().max()))
        return losses, moved

    # bench.py's loop as it is: at lr 1e-3 the mean over 512*512*3 values
    # makes every update smaller than half an ulp of the parameters, so
    # they do not move in float32. The loss must fall at a learning rate
    # scaled by that count (the same steps on the summed squared error).
    reset_counts(fused_tiles, packed_transpose)
    losses, moved = four_steps(LR)
    train_launches = launch_counts(fused_tiles, packed_transpose)
    n_values = plan.height * plan.width * 3
    losses_n, moved_n = four_steps(LR * n_values)
    print(f"4 SGD steps at lr {LR}: loss {losses}, largest parameter "
          f"change {moved:.3e}; launches {train_launches}", flush=True)
    print(f"4 SGD steps at lr {LR} x {n_values}: loss {losses_n} (psnr "
          f"{float(psnr(torch.tensor(losses_n[-1]))):.4f} dB), largest "
          f"parameter change {moved_n:.3e}", flush=True)
    require(all(np.isfinite(losses + losses_n)),
            "training loss is not finite")
    require(all(b < a for a, b in zip(losses_n, losses_n[1:])),
            "training loss does not fall")
    _, step = trainer(LR)

    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, step, STEPS, warmup=2)
    train_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    plain_train = P.DenseGridField.create(config, device=dev)
    plain_opt = torch.optim.SGD(plain_train.parameters(), lr=LR)

    def plain_step():
        plain_opt.zero_grad(set_to_none=True)
        loss = mse(tiled.render_tiled(plan, plain_train, sched,
                                      use_kernel=False).image, target)
        loss.backward()
        plain_opt.step()

    plain_step_ms = cuda_ms(torch, plain_step, 1, warmup=1)
    k2_ms = cuda_ms(torch, lambda: [fused_tiles.tile_backward(
        *a[:6], gs, a[6]) for a, gs in zip(args, gss)], 20)
    k2_plain_ms = cuda_ms(torch, lambda: [fused_tiles.tile_backward_plain(
        *a[:6], gs, a[6]) for a, gs in zip(args, gss)], 1, warmup=1)
    reduce_ms = cuda_ms(torch, lambda: gather_plan.slot_rows_to_table(
        all_rows, sched.gather_plan, n_rows), 20)
    k4_ms = cuda_ms(torch, lambda: packed_transpose.table_grad_to_params(
        tg, sigma.shape), 50)
    k4_plain_ms = cuda_ms(
        torch, lambda: packed_transpose.table_grad_to_params_plain(
            tg, sigma.shape), 20)
    print(f"training step {step_ms:.4f} ms/step = "
          f"{n_rays / step_ms / 1e3:.3f} Mrays/s over {STEPS} steps (plain "
          f"path {plain_step_ms:.4f} ms/step); peak device memory "
          f"{train_peak_mb:.1f} MiB", flush=True)
    print(f"backward stages ms/step: K2 {k2_ms:.4f} over {len(args)} "
          f"launches (plain {k2_plain_ms:.4f}), slot reduction "
          f"{reduce_ms:.4f}, K4 {k4_ms:.4f} (plain {k4_plain_ms:.4f})",
          flush=True)

    # bounds: each kernel's inputs and outputs at this run's shapes, and
    # its operations per live sample (K3 and K4 copy and add: bytes)
    k1_in = sum(nbytes(*a[:6]) for a in args)
    k1_out = sum(g.n_tiles * 5 * 256 * 4 for g in sched.groups)
    k2_out = sum(nbytes(r) for r in k2_rows)
    live = sched.tiled_samples
    kernels = [
        {"name": "fused_tiles", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:656",
         "launches": launches["fused_tiles"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         **bound(k1_in + k1_out, live * DENSE_FWD_OPS)},
        {"name": "packed_table", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:81",
         "launches": launches["packed_table"],
         "max_abs_err": float((rows_k - rows_p).abs().max()),
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         **bound(nbytes(sigma, color, rows_k), 0)},
        {"name": "fused_tiles_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles_bwd.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:714",
         "launches": train_launches["fused_tiles_bwd"],
         "max_abs_err": k2_raw, "ms": k2_ms, "plain_ms": k2_plain_ms,
         **bound(k1_in + sum(nbytes(g) for g in gss) + k2_out,
                 live * DENSE_BWD_OPS)},
        {"name": "packed_table_bwd", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table_bwd.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:119",
         "launches": train_launches["packed_table_bwd"],
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
         **bound(nbytes(tg, *k4_out), 8 * sum(x.numel() for x in k4_out))},
    ]
    if only == "dense":
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({
            "forward_ms": fwd_ms, "stages_ms": {
                "packed_table": k3_ms, "bank_gather": gather_ms,
                "fused_tiles": k1_ms, "compose": compose_ms},
            "train_step_ms": step_ms, "backward_stages_ms": {
                "fused_tiles_bwd": k2_ms, "slot_reduction": reduce_ms,
                "packed_table_bwd": k4_ms}, "card": card}), flush=True)
        print(card_line(), flush=True)
        return device
    elapsed("1-10")
    table_kernels, table_report = run_tables(
        torch, P, dev, plan, config, renderer, result, all_rows)
    kernels += table_kernels
    elapsed("21-27")
    hash_kernels, hash_report = run_hash(torch, P, dev)
    kernels += hash_kernels
    elapsed("11-15")
    grid_kernels, grid_report = run_grid(torch, P, dev)
    kernels += grid_kernels
    elapsed("16-20")
    sub_kernels, sub_report = run_subtiles(torch, P, dev, card)
    kernels += sub_kernels
    elapsed("28-33")
    for phase, finest in ((34, 32), (35, 64)):
        view_kernels, hash_report[f"grid_views_{finest}"] = run_grid_views(
            torch, P, dev, card, finest)
        kernels += view_kernels
        elapsed(str(phase))
    fit_kernels, hash_report["fit_dense_grid"] = run_fit_flagship(
        torch, P, dev, card, sub_report["fit_flagship"]["adam_step_ms"])
    kernels += fit_kernels
    elapsed("36")
    hash_report["grid"] = grid_report
    hash_report["tables"] = table_report
    hash_report["subtiles"] = sub_report
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({**hash_report,
        "forward_ms": fwd_ms, "forward_mrays_s": n_rays / fwd_ms / 1e3,
        "plain_forward_ms": plain_fwd_ms, "renderer_forward_ms": host_ms,
        "stages_ms": {"packed_table": k3_ms, "bank_gather": gather_ms,
                      "fused_tiles": k1_ms, "compose": compose_ms},
        "schedule_build_s": build_s, "peak_mib": peak_mb,
        "forward_vs_plain": e2e_err, "depth_vs_plain": e2e_depth,
        "train_step_ms": step_ms, "train_mrays_s": n_rays / step_ms / 1e3,
        "plain_train_step_ms": plain_step_ms, "train_losses": losses,
        "train_losses_scaled_lr": losses_n,
        "train_peak_mib": train_peak_mb,
        "backward_stages_ms": {"fused_tiles_bwd": k2_ms,
                               "slot_reduction": reduce_ms,
                               "packed_table_bwd": k4_ms},
        "k2_rel_err": k2_err, "k2_rayt_rel_err": k2_cam_err,
        "backward_vs_plain": bwd_errs, "card": card}), flush=True)
    print(card_line(), flush=True)
    return device


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--only", choices=("all", "dense", "grid"), default="all",
        help="'dense': phases 1-10 alone (the dense headline); 'grid': phase "
             "1 and phases 16-20 (the grid headline); each for timing two "
             "trees against each other in one call")
    args = parser.parse_args()
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: no torch: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    try:
        device = run(args.only)
    except Exception:  # report any failed phase, then fail the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
