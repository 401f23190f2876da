#!/usr/bin/env python3
"""Time K7b and K7f with parts of their work cut out, on one CUDA card.

    python3 tools/torch_hash_bwd_ablate.py [--csrc DIR] [--tag NAME]

Builds variants of ``dvren_tpu_torch/csrc/hash_tiles_bwd.cu`` (K7b) and
``hash_tiles.cu`` (K7f), each with one part skipped or replaced by a
patch of its source, into ``dvren_tpu_torch/_build/ablate_k7/`` (one
``nvcc`` per variant, all started together), loads each as a library of
its own and times its ``dvt_hash_backward`` / ``dvt_hash_forward`` with
CUDA events on the inputs the main path gives the kernel:

- the hash headline (``chip_smoke.py`` phase 11: 512^2, 128 stratified
  steps, L=8, T=128, F=2, hidden 8; 1,024 tiles x 16 chunks);
- the fit's four-view stack (phase 14: 4 views at 96^2, 64 steps; 160
  tiles x 8 chunks), for the student (seed 3) and for the teacher made
  opaque (seed 1, table std 1, sigma_b2 + 5: rays stop early); K7b only.

A variant's outputs are wrong by design; only its time counts, and the
differences say what each part costs inside the whole kernel (ptxas
allocates each variant anew, so the parts do not add up exactly).
K7b variants: ``full``; ``no_scatter`` (no d(encoding) and no table
scatter); ``no_products`` (no MLP-gradient products); ``pass1`` (pass 1
alone); with the present sources also ``one_group`` (the scatter's cell
groups one at a time, not two with their butterflies overlapped) and
``row_pairs`` (each warp's rays a 2x16 row pair of the tile, not a 4x8
block). K7f variants: ``full``; ``const_mlp`` (every MLP scalar read a
constant); ``const_table`` (every table read a constant made from the
corner's hashed entry, so the hashing stays); with the present sources
also ``3_blocks`` and ``4_blocks`` (the kernel as it is, its launch
bounds asking for 3 or 4 resident blocks per SM where it asks for 2). Each
variant's ptxas lines (registers, spills) are printed.

``--csrc DIR`` builds from another tree's sources (the parent's, unpacked
from a ``git archive``): the patches find their places by exact source
lines, with one set of anchors for the sources before the kernels' redesign
(``ANCHORS["first"]``) and one for the present ones (``"rows"``); the set
whose every anchor is in DIR's sources as many times as it says is used,
and the script stops if neither is. An edit of K7 that changes one of
those lines must change its anchor here too. The wrapper's partial
outputs are allocated at their largest (one row per warp), which either
tree's kernel fills in part. Prints one JSON line per variant, then the
card line. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path = [p for p in sys.path
            if os.path.abspath(p or ".") != os.path.join(HERE, "tools")]
sys.path.insert(0, HERE)

BWD, FWD = "hash_tiles_bwd.cu", "hash_tiles.cu"
CUH = "hash_tiles.cuh"
C1 = "make_float4(0.01f, 0.02f, 0.03f, 0.04f)"

# variant -> (kernel source, [(file, old text, new text, count)])
ANCHORS = {
    "first": {
        "k7b_full": (BWD, []),
        "k7b_no_scatter": (BWD, [(
            BWD, "    for (int l = 0; l < k.n_levels; ++l) {\n"
                 "      float w[8], denc[kMaxLevels];",
            "    for (int l = 0; l < 0; ++l) {\n"
            "      float w[8], denc[kMaxLevels];", 1)]),
        "k7b_no_products": (BWD, [(
            BWD, "      if (ray + m * kRays < k.n_sc) {",
            "      if (false) {", 1)]),
        "k7b_pass1": (BWD, [(
            BWD, "  for (int q = n_steps - 1; q >= 0; --q) {",
            "  for (int q = -1; q >= 0; --q) {", 1)]),
        "k7f_full": (FWD, []),
        "k7f_const_mlp": (FWD, [
            (CUH, "mul(sc[lay.sw1 + j * k.enc + i], e)", "mul(0.01f, e)", 1),
            (CUH, "mul(sc[lay.cw1 + j * k.enc + i], e)", "mul(0.02f, e)", 1),
            (CUH, "add(pre_s[j], sc[lay.sb1 + j])", "add(pre_s[j], 0.01f)",
             1),
            (CUH, "add(pre_c[j], sc[lay.cb1 + j])", "add(pre_c[j], 0.02f)",
             1),
            (CUH, "mul(sc[lay.sw2 + j], fmaxf(pre_s[j], 0.f))",
             "mul(0.01f, fmaxf(pre_s[j], 0.f))", 1),
            (CUH, "  return add(acc, sc[lay.sb2]);",
             "  return add(acc, 0.01f);", 1),
            (CUH, "        acc = add(acc, mul(sc[lay.cw2 + ch * k.hidden + j],",
             "        acc = add(acc, mul(0.01f,", 1),
            (CUH, "    out[ch] = add(acc, sc[lay.cb2 + ch]);",
             "    out[ch] = add(acc, 0.01f);", 1)]),
        "k7f_const_table": (FWD, [(
            CUH, "e = add(e, mul(w[c], lt[id[c] * k.n_feat]));",
            "e = add(e, mul(w[c], (float)(id[c] & 1)));", 1)]),
    },
    "rows": {
        "k7b_full": (BWD, []),
        "k7b_no_scatter": (BWD, [(
            BWD, "    for (int l = 0; l < k.n_levels; ++l) {\n"
                 "      float w[8] = {",
            "    for (int l = 0; l < 0; ++l) {\n"
            "      float w[8] = {", 1)]),
        "k7b_no_products": (BWD, [(
            BWD, "    for (unsigned m = act; m; m &= m - 1) {",
            "    for (unsigned m = 0; m; m &= m - 1) {", 1)]),
        "k7b_pass1": (BWD, [(
            BWD, "  for (int q = q_hi - 1; q >= 0; --q) {",
            "  for (int q = -1; q >= 0; --q) {", 1)]),
        "k7b_one_group": (BWD, [(
            BWD, "          if (two && pending != 0) {",
            "          if (false) {", 1)]),
        "k7b_row_pairs": (BWD, [(
            BWD, "  const int ray = ((wt >> 1) * 4 + (lane >> 3)) * 16"
                 " + (wt & 1) * 8\n                  + (lane & 7);",
            "  const int ray = wt * 32 + lane;", 1)]),
        "k7f_full": (FWD, []),
        "k7f_const_mlp": (FWD, [
            (CUH, "  const float4 a = *reinterpret_cast<const float4*>(src);",
             f"  const float4 a = {C1};", 1),
            (CUH, "  if (hidden > 4) b = *reinterpret_cast<const float4*>"
                  "(src + 4);", f"  if (hidden > 4) b = {C1};", 1),
            (CUH, "  const float b2 = rows[mr.b2()];",
             "  const float b2 = 0.01f;", 1),
            (CUH, "  const float4 b2 = *reinterpret_cast<const float4*>"
                  "(rows + mr.b2());", f"  const float4 b2 = {C1};", 1)]),
        "k7f_3_blocks": (FWD, [(FWD, "__launch_bounds__(kRays, 2)",
                                "__launch_bounds__(kRays, 3)", 1)]),
        "k7f_4_blocks": (FWD, [(FWD, "__launch_bounds__(kRays, 2)",
                                "__launch_bounds__(kRays, 4)", 1)]),
        "k7f_const_table": (FWD, [(
            CUH, "            v[c] = *reinterpret_cast<const float2*>"
                 "(lt + id[n][c] * n_f + f);",
            "            v[c] = make_float2((float)(id[n][c] & 1), "
            "(float)(id[n][c] & 2));", 1)]),
    },
}


def anchor_set(csrc: str) -> str:
    """The anchor set every patch of which matches ``csrc``'s sources."""
    texts = {name: open(os.path.join(csrc, name)).read()
             for name in (BWD, FWD, CUH)}
    for key, variants in ANCHORS.items():
        if all(texts[f].count(old) == n
               for _, patches in variants.values()
               for f, old, _, n in patches):
            return key
    raise RuntimeError(f"no anchor set matches the sources in {csrc}")


def build(csrc: str, tag: str) -> dict:
    """Each variant's entry point, built in parallel: name -> (function,
    ptxas lines)."""
    from dvren_tpu_torch import _build

    variants = ANCHORS[anchor_set(csrc)]
    root = os.path.join(HERE, "dvren_tpu_torch", "_build", "ablate_k7", tag)
    jobs = {}
    for name, (source, patches) in variants.items():
        work = os.path.join(root, name)
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(csrc, work)
        for fname, old, new, _ in patches:
            path = os.path.join(work, fname)
            with open(path) as f:
                text = f.read()
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        jobs[name] = (os.path.join(work, "lib.so"),
                      [os.path.join(work, source)])
    loaded = {}
    for name, (lib, out) in _build.build_variants(jobs).items():
        entry = ("dvt_hash_backward" if name.startswith("k7b")
                 else "dvt_hash_forward")
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = _build._SIGNATURES[entry]
        ptxas = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        loaded[name] = (fn, ptxas)
    return loaded


def launcher(torch, name, fn, args, gs):
    """A call of variant ``fn`` on one K7 launch's arguments."""
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import hash_tiles

    samp, rayt, table, sc, prm = args
    dev = samp.device
    t_cnt = int(samp.shape[0])
    res, consts = hash_tiles._kernel_args(prm)
    stream = _build.stream_ptr(dev)
    if name.startswith("k7f"):
        out = torch.empty((t_cnt, 5, 16, 16), device=dev)

        def call():
            _build.check(fn(samp.data_ptr(), rayt.data_ptr(),
                            table.data_ptr(), sc.data_ptr(), out.data_ptr(),
                            t_cnt, *consts, ctypes.cast(res, ctypes.c_void_p),
                            stream), name)
        return call
    part_tab = torch.empty((t_cnt * 8, table.numel()), device=dev)
    part_mlp = torch.empty((t_cnt * 8, sc.numel()), device=dev)
    s_pre = torch.empty((t_cnt, prm.n_chunks * 8, 256), device=dev)

    def call():
        _build.check(fn(samp.data_ptr(), rayt.data_ptr(), table.data_ptr(),
                        sc.data_ptr(), gs.data_ptr(), part_tab.data_ptr(),
                        part_mlp.data_ptr(), s_pre.data_ptr(), t_cnt,
                        *consts, ctypes.cast(res, ctypes.c_void_p), stream),
                     name)
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--csrc", default=os.path.join(
        HERE, "dvren_tpu_torch", "csrc"),
        help="the kernel sources to patch (default: this tree's)")
    parser.add_argument("--tag", default="this",
                        help="name of the build directory and of the rows")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_hash_bwd_ablate: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    import dvren_tpu_torch as P
    from dvren_tpu_torch.ops import hash_tiles
    from dvren_tpu_torch.opt import fit
    from dvren_tpu_torch.render import hash_tiled

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fns = build(os.path.abspath(opts.csrc), opts.tag)
    gen = torch.Generator(device=dev).manual_seed(7)

    def inputs(plan, spec, sched, params):
        prm = hash_tiles.hash_tile_params(plan, spec, sched.n_chunks)
        args = (sched.samp, sched.rayt,
                params["hash_table"].detach().contiguous(),
                hash_tiles.pack_mlp_scalars(params, spec).detach(), prm)
        gs = torch.randn((sched.samp.shape[0], 5, 16, 16), generator=gen,
                         device=dev)
        return args, gs

    plan, spec = cs.hash_headline(P)
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                       spec=spec, device=dev)
    cells = {"headline": inputs(plan, spec, hash_tiled.build_hash_schedule(
        plan, device=dev), dict(field.params))}
    f_plan, cams = cs.hash_fit_setup(P)
    stack = hash_tiled.build_hash_schedule_stack(
        fit.view_plans(f_plan, cams), device=dev)
    student = P.HashMLPField.init_random(torch.Generator().manual_seed(3),
                                         spec=spec, device=dev)
    teacher = P.HashMLPField.init_random(torch.Generator().manual_seed(1),
                                         spec=spec, table_std=1.0,
                                         device=dev)
    opaque = {k: v.detach().clone() for k, v in teacher.params.items()}
    opaque["sigma_b2"] += cs.OPAQUE_BIAS
    cells["fit_student"] = inputs(f_plan, spec, stack, dict(student.params))
    cells["fit_opaque"] = inputs(f_plan, spec, stack, opaque)
    for cname, (args, _) in cells.items():
        print(f"{cname}: {args[0].shape[0]} tiles x {args[4].n_chunks} "
              f"chunks, {cs.hash_processed(hash_tiles, *args)} processed "
              f"samples", flush=True)
    card = cs.card_line()
    for name, (fn, ptxas) in fns.items():
        row = {"tree": opts.tag, "variant": name, "card": card,
               "ptxas": ptxas}
        for cname, (args, gs) in cells.items():
            if name.startswith("k7f") and cname != "headline":
                continue
            call = launcher(torch, name, fn, args, gs)
            row[f"{cname}_ms"] = cs.cuda_ms(torch, call, 10, warmup=2)
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
