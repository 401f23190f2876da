#!/usr/bin/env python3
"""Time K8b with parts of its work cut out, on one CUDA card.

    python3 tools/torch_grid_bwd_ablate.py

Builds variants of ``dvren_tpu_torch/csrc/hash_grid_bwd.cu``, each with one
part skipped by a patch of its source, into
``dvren_tpu_torch/_build/ablate/`` (one ``nvcc`` per variant, all started
together), loads each as a library of its own and times its
``dvt_hash_grid_backward`` with CUDA events on the inputs the main path
gives K8b: the grid headline (``chip_smoke.py`` phase 16's schedule, 16
px, one launch) and the grid views at finest 32 (phase 34's eight
schedules, 8 px, one launch each). A variant's outputs are wrong by
design; only its time counts, and the differences say what each part
costs inside the whole kernel (ptxas allocates each variant anew, so the
parts do not add up exactly). Variants:

- ``full``: the kernel as it is;
- ``no_mlp``: without the per-step MLP sums (the factor rows are still
  staged);
- ``no_scatter``: without the window scatter and its flush;
- ``pass1``: pass 1 alone (the recurrence and the prefix store).

Prints one JSON line per variant, then the card line. Exits 1 without a
card.

The patches find their places by exact lines of the kernel's source
(``VARIANTS``): an edit of K8b that changes one of those lines must change
its anchor here too. The script stops, naming the anchor, when one is not
in the source exactly once.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path = [p for p in sys.path
            if os.path.abspath(p or ".") != os.path.join(HERE, "tools")]
sys.path.insert(0, HERE)

VARIANTS = {
    "full": [],
    "no_mlp": [("          if (own[kk] >= 0) {\n            const float4* a4",
                "          if (false) {\n            const float4* a4")],
    "no_scatter": [("for (int sb = 0; sb < SUBS; ++sb) {",
                    "for (int sb = 0; sb < 0; ++sb) {")],
    "pass1": [("for (int c = nc - 1; c >= 0; --c) {",
               "for (int c = nc - 1; c >= nc; --c) {")],
}


def build(names) -> dict:
    """Each variant's library, built in parallel."""
    from dvren_tpu_torch import _build

    src = os.path.join(HERE, "dvren_tpu_torch", "csrc")
    root = os.path.join(HERE, "dvren_tpu_torch", "_build", "ablate")
    jobs = {}
    for name in names:
        work = os.path.join(root, name)
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(src, work)
        path = os.path.join(work, "hash_grid_bwd.cu")
        with open(path) as f:
            text = f.read()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch anchor {old!r} is "
                                   f"not in the source exactly once")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = (os.path.join(work, "lib.so"), [path])
    loaded = {}
    for name, (lib, _) in _build.build_variants(jobs).items():
        fn = lib.dvt_hash_grid_backward
        fn.argtypes, fn.restype = _build._SIGNATURES["dvt_hash_grid_backward"]
        loaded[name] = fn
    return loaded


def launcher(torch, fn, args, gs):
    """A call of ``fn`` on one schedule's one-launch K8b arguments."""
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import hash_grid

    tabs, tiles, sc, prm = args
    dev = tabs.device
    d_rows = torch.empty((int(tabs.shape[0]) * 128, prm.cols), device=dev)
    part = torch.empty((tiles.n_tiles, int(sc.shape[0])), device=dev)
    s_pre = torch.empty((int(tiles.samp.shape[0]) * 8, 256), device=dev)
    ratios, consts = hash_grid._kernel_args(prm)
    stream = _build.stream_ptr(dev)

    def call():
        code = fn(tabs.data_ptr(), tiles.samp.data_ptr(),
                  tiles.base.data_ptr(), tiles.rayt.data_ptr(),
                  tiles.ke.data_ptr(), tiles.bank0.data_ptr(),
                  tiles.desc.data_ptr(), sc.data_ptr(), gs.data_ptr(),
                  d_rows.data_ptr(), part.data_ptr(), s_pre.data_ptr(),
                  tiles.n_tiles, *consts,
                  ctypes.cast(ratios, ctypes.c_void_p), stream)
        _build.check(code, "dvt_hash_grid_backward")

    return call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_grid_bwd_ablate: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    import dvren_tpu_torch as P
    from dvren_tpu_torch.render import hash_tiled

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fns = build(list(VARIANTS))
    gen = torch.Generator(device=dev).manual_seed(9)

    def cell(plans, spec):
        field = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                           spec=spec, device=dev)
        params = {k: v.detach() for k, v in field.params.items()}
        out = []
        for pv in plans:
            sched = hash_tiled.build_hash_grid_schedule(pv, field, device=dev)
            args = cs.grid_tiles_args(pv, spec, sched, params)[1]
            gs = torch.randn((args[1].n_tiles, 5, 16, 16), generator=gen,
                             device=dev)
            out.append((args, gs))
        return out

    plan, _ = cs.hash_headline(P)
    cells = {"grid_headline": cell([plan], P.HashMLPSpec(**cs.GRID_SPEC)),
             "grid_views_32": cell(cs.flagship_views(P)[0],
                                   P.HashMLPSpec(**cs.grid_view_spec(32)))}
    card = cs.card_line()
    for name, fn in fns.items():
        row = {"variant": name, "card": card}
        for cname, inputs in cells.items():
            calls = [launcher(torch, fn, a, gs) for a, gs in inputs]
            row[f"{cname}_ms"] = cs.cuda_ms(
                torch, lambda: [c() for c in calls], 5, warmup=1)
            row[f"{cname}_launches"] = len(calls)
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
