#!/usr/bin/env python3
"""Time K2 with parts of its work cut out, on one CUDA card.

    python3 tools/torch_tile_bwd_ablate.py

Builds variants of ``dvren_tpu_torch/csrc/fused_tiles_bwd.cu``, each with
one part skipped by a patch of its source, into
``dvren_tpu_torch/_build/ablate_k2/`` (one ``nvcc`` per variant, all started
together), loads each as a library of its own and times its
``dvt_tile_backward`` (rows form, no camera adjoint, one launch per
schedule) with CUDA events on the inputs the main path gives K2: the dense
headline (``chip_smoke.py`` phase 3's schedule: 16 px cells, subs 1) and
the fine grid in bfloat16 (phase 30's cascade: 8 px cells, subs 4). A
variant's outputs are wrong by design; only its time counts, and the
differences say what each part costs inside the whole kernel (ptxas
allocates each variant anew, so the parts do not add up exactly).
Variants:

- ``full``: the kernel as it is;
- ``no_flush``: the window scatter into shared memory without its flush
  into the bank rows;
- ``no_scatter``: without the window scatter and its flush;
- ``pass1``: pass 1 alone (the recurrence and the prefix store).

``full`` is timed in two orders of tiles too: the schedule's (the tiles
by falling chunk count, ``TileSet.order``) and group order (the identity:
the groups come by rising chunk count), and K1 likewise, from the port's
own library. Prints one JSON line per variant, then the card line. Exits
1 without a card.

The patches find their places by exact lines of the kernel's source
(``VARIANTS``: old text, new text, count): an edit of K2 that changes one
of those lines must change its anchor here too. The script stops, naming
the anchor, when one is not in the source as many times as it says.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path = [p for p in sys.path
            if os.path.abspath(p or ".") != os.path.join(HERE, "tools")]
sys.path.insert(0, HERE)

SOURCE = "fused_tiles_bwd.cu"
VARIANTS = {
    "full": [],
    "no_flush": [("  // the window's flush into the bank rows\n",
                  "  return;\n", 1)],
    "no_scatter": [("  // the window scatter into shared memory\n",
                    "  return 0u;\n", 1)],
    "pass1": [("  for (int c = span.nc - 1; c >= 0; --c) {",
               "  for (int c = span.nc - 1; c >= span.nc; --c) {", 1)],
}


def build(names) -> dict:
    """Each variant's ``dvt_tile_backward``, built in parallel."""
    from dvren_tpu_torch import _build

    src = os.path.join(HERE, "dvren_tpu_torch", "csrc")
    root = os.path.join(HERE, "dvren_tpu_torch", "_build", "ablate_k2")
    jobs = {}
    for name in names:
        work = os.path.join(root, name)
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(src, work)
        path = os.path.join(work, SOURCE)
        with open(path) as f:
            text = f.read()
        for old, new, count in VARIANTS[name]:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: the patch anchor {old!r} is "
                                   f"not in the source {count} time(s)")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = (os.path.join(work, "lib.so"), [path])
    loaded = {}
    for name, (lib, _) in _build.build_variants(jobs).items():
        fn = lib.dvt_tile_backward
        fn.argtypes, fn.restype = _build._SIGNATURES["dvt_tile_backward"]
        loaded[name] = fn
    return loaded


def launcher(torch, fn, args, gs, order=None):
    """A call of ``fn`` on one schedule's one-launch K2 arguments, its
    tiles in ``order`` (by default the schedule's)."""
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import fused_tiles

    tabs, tiles, prm = args
    dev = tabs.device
    order = tiles.order if order is None else order
    d_rows = torch.empty((tiles.n_bank_rows, 128, prm.cols), device=dev)
    s_pre = torch.empty((tiles.n_chunk_rows * 8, 256), device=dev)
    stream = _build.stream_ptr(dev)

    def call():
        code = fn(tabs.data_ptr(), tiles.samp.data_ptr(),
                  tiles.base.data_ptr(), tiles.rayt.data_ptr(),
                  tiles.ke.data_ptr(), tiles.bank0.data_ptr(),
                  tiles.desc.data_ptr(), order.data_ptr(), gs.data_ptr(),
                  d_rows.data_ptr(),
                  None, s_pre.data_ptr(), tiles.n_tiles, prm.k_max,
                  prm.subs, int(prm.stencil == "super"), 0, prm.dt,
                  prm.t_near, prm.t_far, prm.t_stop, prm.stop, *prm.lo,
                  *prm.inv, *prm.ns, *fused_tiles.camera_scales(prm),
                  stream)
        _build.check(code, "dvt_tile_backward")

    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tile_bwd_ablate: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import dataclasses

    import chip_smoke as cs
    import dvren_tpu_torch as P
    from dvren_tpu_torch.ops import fused_tiles
    from dvren_tpu_torch.render import tiled

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fns = build(list(VARIANTS))
    gen = torch.Generator(device=dev).manual_seed(11)

    def cell(grid_n, max_steps, dtype):
        plan, config = cs.headline_scene(P, grid_n=grid_n,
                                         max_steps=max_steps)
        field = P.DenseGridField.create(config, device=dev).with_packed_dtype(
            dtype).requires_grad_(False)
        sched, note = tiled.build_tiled_schedule_auto(plan, field)
        args = cs.variant_args(torch, plan, field, sched.to(dev))
        gs = torch.randn((args[1].n_tiles, 5, 16, 16), generator=gen,
                         device=dev)
        print(f"{dtype} {grid_n}^3: {note or 'tiled_16px'}, "
              f"{len(sched.groups)} groups, {args[1].n_tiles} tiles",
              flush=True)
        return args, gs

    cells = {"dense_headline": cell(64, 128, "float32"),
             "finegrid_bf16": cell(128, 256, "bfloat16")}
    card = cs.card_line()

    def identity(args):
        return torch.arange(args[1].n_tiles, dtype=torch.int32, device=dev)

    for name, fn in fns.items():
        row = {"variant": name, "card": card}
        for cname, (args, gs) in cells.items():
            call = launcher(torch, fn, args, gs)
            row[f"{cname}_ms"] = cs.cuda_ms(torch, call, 10, warmup=2)
        print(json.dumps(row), flush=True)
    row = {"variant": "full_group_order", "card": card}
    for cname, (args, gs) in cells.items():
        call = launcher(torch, fns["full"], args, gs, identity(args))
        row[f"{cname}_ms"] = cs.cuda_ms(torch, call, 10, warmup=2)
    print(json.dumps(row), flush=True)
    for what, order in (("k1", None), ("k1_group_order", identity)):
        row = {"variant": what, "card": card}
        for cname, ((tabs, tiles, prm), _) in cells.items():
            t = tiles if order is None else dataclasses.replace(
                tiles, order=order((tabs, tiles, prm)))
            row[f"{cname}_ms"] = cs.cuda_ms(
                torch, lambda: fused_tiles.tile_forward(tabs, t, prm), 10,
                warmup=2)
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
