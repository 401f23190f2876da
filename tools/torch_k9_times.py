#!/usr/bin/env python3
"""Compare K9f and K9b, the per-ray integrator, with another tree's on one
CUDA card.

    python3 tools/torch_k9_times.py PARENT [--shapes NAME,...]

``PARENT`` is another tree (a ``git archive`` unpacked under
``_archive/``). Its integrator sources (``csrc/integrate.cu``,
``integrate_bwd.cu``) are built into a library of their own
(``_build.build_variants``). At every K9 shape ``chip_smoke.py`` runs (the
windowed headline's 8 groups and the same at sigma x 10, phase 37; the
streamed headline's 8 blocks of 32,768 x 128, phase 52; the fused lattice
262,144 x 128, phase 53; the override bundle 524,288 x 128, phase 55; the
fine grid's fallback groups at 16 px, 256 steps, phase 39; the first
131,072 rays of the headline; a 96^2 flagship view, 9,216 x 96), built
from ``chip_smoke``'s helpers in this one process, both trees' kernels
run through the same ctypes call: their outputs are compared (bit-equal,
or the largest difference) and both are timed on the device alone
(``chip_smoke.device_ms``) and as issued (``chip_smoke.cuda_ms``), in
turns: parent, this tree, this tree, parent. The kernels' checks against
their twins, their bounds and their waves at these shapes are
``chip_smoke.k9_entries``'.

Prints the parent's ``ptxas`` lines for its integrator kernels, one JSON
line per shape, then the card line. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 20
SHAPES = ("window_headline", "window_headline_x10", "streamed_headline",
          "fused_headline", "override", "fallback_16px", "rays_131072",
          "view_96")


def bind(lib, geometry: bool):
    """Set the entry points' argtypes: with ``geometry`` the (chunks,
    blocks) ints after (n, k), as this tree's; without, the signature
    before the register design."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    g = [I, I] if geometry else []
    lib.dvt_integrate_forward.argtypes = [P] * 8 + [I, I] + g + [F] * 4 + [P]
    lib.dvt_integrate_backward.argtypes = [P] * 11 + [I, I] + g + [F, P]
    lib.dvt_integrate_forward.restype = I
    lib.dvt_integrate_backward.restype = I
    return lib


def calls(torch, lib, geometry, inputs, gs, span):
    """(forward, backward): closures launching every group through ``lib``
    with the wrapper's arguments, outputs allocated as the wrapper does."""
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import integrate_fused as fz
    from dvren_tpu_torch.ops.integrate import OPACITY_EPS, STOP_THRESHOLD

    dev = inputs[0][0].device
    stream = _build.stream_ptr(dev)

    def geo(n, k):
        return list(fz.launch_geometry(n, k)) if geometry else []

    def fwd():
        outs = []
        for sigma, (cr, cg, cb), dt, mask, origin in inputs:
            n, k = sigma.shape
            out = torch.empty((n, 8), dtype=torch.float32, device=dev)
            code = lib.dvt_integrate_forward(
                sigma.data_ptr(), cr.data_ptr(), cg.data_ptr(),
                cb.data_ptr(), dt.data_ptr(), mask.data_ptr(),
                origin.data_ptr() if origin is not None else None,
                out.data_ptr(), n, k, *geo(n, k), float(span[0]),
                float(span[1]), STOP_THRESHOLD, OPACITY_EPS, stream)
            _build.check(code, "dvt_integrate_forward")
            outs.append(out)
        return outs

    def bwd():
        outs = []
        for (sigma, (cr, cg, cb), dt, mask, _), g in zip(inputs, gs):
            n, k = sigma.shape
            o = [torch.empty((n, k), dtype=torch.float32, device=dev)
                 for _ in range(4)]
            code = lib.dvt_integrate_backward(
                sigma.data_ptr(), cr.data_ptr(), cg.data_ptr(),
                cb.data_ptr(), dt.data_ptr(), mask.data_ptr(), g.data_ptr(),
                *(x.data_ptr() for x in o), n, k, *geo(n, k), STOP_THRESHOLD,
                stream)
            _build.check(code, "dvt_integrate_backward")
            outs.append(o)
        return outs

    return fwd, bwd


def difference(torch, a, b) -> float:
    """Largest |a - b| over lists of tensors (0.0 when bit-equal)."""
    flat_a = [x for y in a for x in (y if isinstance(y, list) else [y])]
    flat_b = [x for y in b for x in (y if isinstance(y, list) else [y])]
    if all(torch.equal(x.view(torch.int32), y.view(torch.int32))
           for x, y in zip(flat_a, flat_b)):
        return 0.0
    return max(float((x - y).abs().max()) for x, y in zip(flat_a, flat_b))


def shape_inputs(torch, P, cs, name, dev):
    """(inputs, radiance cotangents, (t_near, t_far)) of a K9 shape, as the
    chip_smoke phase named in the module docstring builds them."""
    from dvren_tpu_torch.render import pipeline, tiled, windowed

    gen = torch.Generator(device=dev).manual_seed(20)
    plan, config = cs.headline_scene(P)
    span = (plan.t_near, plan.t_far)
    if name in ("fallback_16px", "view_96"):
        if name == "fallback_16px":
            plan, config = cs.headline_scene(P, grid_n=128, max_steps=256)
            field = P.DenseGridField.create(config, device=dev)
            sched = tiled.build_tiled_schedule(plan, field, tile_px=16)
            inputs = cs.window_group_inputs(torch, plan, field,
                                            sched.fallback.to(dev))
        else:
            plans, config = cs.flagship_views(P)
            plan = plans[0]
            field = P.DenseGridField.create(config, device=dev)
            with torch.no_grad():
                inputs = cs.outputs_inputs(pipeline.render(plan, field))
        span = (plan.t_near, plan.t_far)
    else:
        field = P.DenseGridField.create(config, device=dev)
        jitter = torch.tensor(pipeline.plan_jitter_table(plan), device=dev)
        if name.startswith("window_headline"):
            sched = windowed.build_schedule(
                plan, field.bbox_min, field.bbox_max,
                jitter=pipeline.plan_jitter_table(plan), device=dev)
            inputs = cs.window_group_inputs(torch, plan, field, sched)
            if name.endswith("_x10"):
                inputs = [(s * 10.0, pl, d, m, o)
                          for s, pl, d, m, o in inputs]
        elif name == "streamed_headline":
            inputs = cs.lattice_blocks(torch, plan, field, jitter,
                                       pipeline.default_ray_tile(plan))
        elif name == "fused_headline":
            inputs = cs.lattice_blocks(torch, plan, field, jitter,
                                       plan.ray_count)
        elif name == "rays_131072":
            inputs = cs.lattice_blocks(torch, plan, field, jitter,
                                       plan.ray_count // 2)[:1]
        elif name == "override":
            oplan, bundle = cs.override_bundle(torch, P, plan, dev)
            r = P.Renderer(P.Context.create(device=dev.type), oplan)
            with torch.no_grad():
                r.forward(field, rays=bundle)
            inputs = cs.outputs_inputs(r.last_outputs)
        else:
            raise ValueError(name)
    inputs = [(s.contiguous(), tuple(c.contiguous() for c in pl),
               d.contiguous(), m.contiguous(),
               o.contiguous() if o is not None else None)
              for s, pl, d, m, o in inputs]
    gs = [torch.rand((x[0].shape[0], 3), generator=gen, device=dev) * 2 - 1
          for x in inputs]
    return inputs, gs, span


def time_pair(torch, cs, fns, order):
    """Device and issued ms of each closure in ``fns``, in ``order``
    (names, repeated: a b b a)."""
    out = {name: {"device_ms": [], "issued_ms": []} for name in fns}
    for name in order:
        out[name]["device_ms"].append(cs.device_ms(torch, fns[name], ITERS))
        out[name]["issued_ms"].append(cs.cuda_ms(torch, fns[name], ITERS))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent", help="the tree whose integrator is "
                                       "compared and timed beside this one")
    parser.add_argument("--shapes", default=",".join(SHAPES),
                        help="comma-separated shapes (default: all)")
    args = parser.parse_args()
    sys.path = [p for p in sys.path
                if os.path.abspath(p or ".") != os.path.join(HERE, "tools")]
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_k9_times: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    import dvren_tpu_torch as P
    from dvren_tpu_torch import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    pdir = os.path.join(os.path.abspath(args.parent), "dvren_tpu_torch",
                        "csrc")
    work = os.path.join(HERE, "dvren_tpu_torch", "_build", "k9_parent")
    os.makedirs(work, exist_ok=True)
    plib, report = _build.build_variants({"parent": (
        os.path.join(work, "lib.so"),
        [os.path.join(pdir, f) for f in ("integrate.cu",
                                         "integrate_bwd.cu")])})["parent"]
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "integrate" in line:
            for x in lines[i:i + 4]:
                if "registers" in x or "spill" in x or "Compiling" in x:
                    print(f"ptxas parent: {x.strip()}")
    pgeo = hasattr(plib, "dvt_integrate_forward_occupancy")
    libs = {"change": (bind(_build.library(), True), True),
            "parent": (bind(plib, pgeo), pgeo)}

    for name in args.shapes.split(","):
        inputs, gs, span = shape_inputs(torch, P, cs, name, dev)
        row = {"shape": name, "launches": len(inputs),
               "rays": [int(x[0].shape[0]) for x in inputs],
               "steps": int(inputs[0][0].shape[1]), "card": card}
        fns = {tag: calls(torch, lib, geo, inputs, gs, span)
               for tag, (lib, geo) in libs.items()}
        with torch.no_grad():
            row["k9f_vs_parent"] = difference(
                torch, fns["change"][0](), fns["parent"][0]())
            row["k9b_vs_parent"] = difference(
                torch, fns["change"][1](), fns["parent"][1]())
        order = ["parent", "change", "change", "parent"]
        row["k9f"] = time_pair(torch, cs, {t: f[0] for t, f in fns.items()},
                               order)
        row["k9b"] = time_pair(torch, cs, {t: f[1] for t, f in fns.items()},
                               order)
        print(json.dumps(row), flush=True)
        del inputs, gs, fns
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
