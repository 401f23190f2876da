#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once, at the headline configuration: the
dense-grid tiled forward render through ``Renderer.forward`` at 512^2
rays over a 64^3 Gaussian-blob grid with 128 stratified steps (seed 3;
the scene ``bench.py::_scene`` builds, rebuilt here in numpy). Phases,
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
   twin.

Prints a JSON line of per-kernel results, then the card line, and as the
last line ``{"ok": true, "device": {...}}``. Exits nonzero, without that
line, when CUDA is missing, a kernel does not build, or any check fails.
Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

TOL = 5e-6          # radiance, transmittance, opacity
TOL_DEPTH = 1e-4    # depth is a ratio: wd / opacity
FRAMES = 30         # timed forward frames


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


def run() -> dict:
    import torch

    import dvren_tpu_torch as P
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import fused_tiles, packed_transpose
    from dvren_tpu_torch.render import tiled

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {}

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

    kernels = [
        {"name": "fused_tiles", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/fused_tiles.cu",
         "replaces": "dvren_tpu/ops/fused_tiles.py:656",
         "launches": launches["fused_tiles"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "packed_table", "route": "cuda",
         "source": "dvren_tpu_torch/csrc/packed_table.cu",
         "replaces": "dvren_tpu/ops/packed_transpose.py:81",
         "launches": launches["packed_table"],
         "max_abs_err": float((rows_k - rows_p).abs().max()),
         "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "forward_ms": fwd_ms, "forward_mrays_s": n_rays / fwd_ms / 1e3,
        "plain_forward_ms": plain_fwd_ms, "renderer_forward_ms": host_ms,
        "stages_ms": {"packed_table": k3_ms, "bank_gather": gather_ms,
                      "fused_tiles": k1_ms, "compose": compose_ms},
        "schedule_build_s": build_s, "peak_mib": peak_mb,
        "forward_vs_plain": e2e_err, "depth_vs_plain": e2e_depth,
        "card": card}), flush=True)
    print(card_line(), flush=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main() -> int:
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
        device = run()
    except Exception:  # report any failed phase, then fail the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
