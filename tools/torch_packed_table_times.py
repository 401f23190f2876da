#!/usr/bin/env python3
"""Time K3, K4, K5a and K5b, the packed-table kernels, on one CUDA card.

    python3 tools/torch_packed_table_times.py [--tree DIR] [--sweep]

Imports ``dvren_tpu_torch`` from DIR (default: this checkout; another
tree's ``git archive``, unpacked under ``_archive/``, times that tree's
kernels with the same script). At 64^3 (``chip_smoke.py``'s headline
field) and at 128^3 (its fine grid, phase 39's grid) it holds K3 and K5a
(bfloat16) to their plain twins as 32-bit / 16-bit words and K4 and K5b
to theirs bit for bit, on a table gradient drawn from seed 6, then times
each wrapper twice with ``chip_smoke.device_ms`` (the stream sleeps on the
card while the host queues the calls: device time alone) and twice with
``chip_smoke.cuda_ms`` (back-to-back calls: the host's cost of issuing
them included), beside each kernel's bound (bytes over 3.35 TB/s).

``--sweep`` (a tree with ``packed_transpose.grad_tiling``) also times K4
at other runs and z-chunks and K3 at other rows per block, each launch
bit-checked against the twin, through the C entry points with the
geometry the helpers give for those sizes.

Prints one JSON line per grid (and per swept geometry), then the card
line. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 100


def bits_equal(torch, a, b) -> bool:
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=HERE,
                        help="the checkout whose dvren_tpu_torch is timed")
    parser.add_argument("--sweep", action="store_true",
                        help="also time K4 and K3 at other geometries")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path = [p for p in sys.path
                if os.path.abspath(p or ".") != os.path.join(HERE, "tools")]
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_packed_table_times: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    import dvren_tpu_torch as P
    from dvren_tpu_torch import _build
    from dvren_tpu_torch.ops import packed_transpose as pt

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.card_line()
    print(card, flush=True)
    print(f"tree {tree}; torch {torch.__version__}", flush=True)
    _build.library()
    lines = _build.ptxas_report().splitlines()
    for k, line in enumerate(lines):     # each entry, then its usage lines
        if "Compiling entry" in line and "packed_table" in line:
            for text in lines[k:k + 3]:
                print("ptxas:", text.strip(), flush=True)

    def times(fn):
        return {"device_ms": [cs.device_ms(torch, fn, ITERS)
                              for _ in range(2)],
                "issued_ms": [cs.cuda_ms(torch, fn, ITERS) for _ in range(2)]}

    def bound_ms(n_bytes):
        return n_bytes / cs.HBM_BYTES_S * 1e3

    for n in (64, 128):
        _, config = cs.headline_scene(P, grid_n=n)
        field = P.DenseGridField.create(config, device=dev)
        sigma, color = field.sigma.detach(), field.color.detach()
        shape = tuple(sigma.shape)
        n_rows = pt.fullpitch_rows(shape)
        gen = torch.Generator(device=dev).manual_seed(6)
        tg = torch.randn((n_rows, 32), generator=gen, device=dev)
        tg16 = tg.to(torch.bfloat16)
        table = pt.build_rows(sigma, color)
        grads = pt.table_grad_to_params(tg, shape)
        table16 = pt.build_rows16(sigma, color, torch.bfloat16)
        grads16 = pt.table16_grad_to_params(tg16, shape)
        torch.cuda.synchronize()
        equal = {
            "k3": bits_equal(torch, table, pt.build_rows_plain(sigma, color)),
            "k4": all(bits_equal(torch, a, b) for a, b in zip(
                grads, pt.table_grad_to_params_plain(tg, shape))),
            "k5a": bits_equal(torch, table16, pt.build_rows16_plain(
                sigma, color, torch.bfloat16)),
            "k5b": all(bits_equal(torch, a, b) for a, b in zip(
                grads16, pt.table16_grad_to_params_plain(tg16, shape)))}
        in_bytes = cs.nbytes(sigma, color)
        row = {
            "grid": n, "card": card, "equal": equal,
            "k3": times(lambda: pt.build_rows(sigma, color)),
            "k4": times(lambda: pt.table_grad_to_params(tg, shape)),
            "k5a": times(lambda: pt.build_rows16(sigma, color,
                                                 torch.bfloat16)),
            "k5b": times(lambda: pt.table16_grad_to_params(tg16, shape)),
            "bound_ms": {
                "k3": bound_ms(in_bytes + cs.nbytes(table)),
                "k4": bound_ms(cs.nbytes(tg, *grads)),
                "k5a": bound_ms(in_bytes + cs.nbytes(table16)),
                "k5b": bound_ms(cs.nbytes(tg16, *grads16))}}
        print(json.dumps(row), flush=True)
        if not all(equal.values()):
            print(f"a kernel differs from its twin at {n}^3: {equal}",
                  file=sys.stderr)
            return 1
        if args.sweep:
            sweep(torch, pt, _build, dev, card, sigma, color, tg, shape,
                  times)
    print(card, flush=True)
    return 0


def sweep(torch, pt, _build, dev, card, sigma, color, tg, shape, times):
    """K4 at runs 128 / 256 and z-chunks 1-16, K3 at 128 / 256 rows a
    block, each bit-checked and timed."""
    lib = _build.library()
    z, y, x = shape
    stream = _build.stream_ptr(dev)
    want4 = pt.table_grad_to_params_plain(tg, shape)
    want3 = pt.build_rows_plain(sigma, color)
    d_sigma, d_color = torch.empty_like(want4[0]), torch.empty_like(want4[1])
    for run in (128, 256):
        for z_chunk in (1, 2, 4, 8, 16):
            tl = pt.grad_tiling(shape, run=run, z_chunk=z_chunk)

            def k4(tl=tl):
                _build.check(lib.dvt_packed_table_grad(
                    tg.data_ptr(), d_sigma.data_ptr(), d_color.data_ptr(),
                    z, y, x, tl.run, tl.z_chunk, tl.runs, tl.lead, tl.span,
                    tl.stride, tl.blocks, tl.smem_bytes, stream),
                    "dvt_packed_table_grad")

            d_sigma.fill_(float("nan"))
            k4()
            torch.cuda.synchronize()
            ok = (bits_equal(torch, d_sigma, want4[0])
                  and bits_equal(torch, d_color, want4[1]))
            print(json.dumps({"sweep": "k4", "grid": z, "run": run,
                              "z_chunk": z_chunk, "blocks": tl.blocks,
                              "smem_bytes": tl.smem_bytes, "equal": ok,
                              **times(k4), "card": card}), flush=True)
    n_rows = pt.fullpitch_rows(shape)
    out = torch.empty_like(want3)
    for rows in (128, 256):
        tl = pt.table_tiling(shape, rows=rows)

        def k3(tl=tl):
            _build.check(lib.dvt_packed_table(
                sigma.data_ptr(), color.data_ptr(), out.data_ptr(),
                z, y, x, n_rows, tl.rows, tl.stride, tl.blocks,
                tl.smem_bytes, stream), "dvt_packed_table")

        out.fill_(float("nan"))
        k3()
        torch.cuda.synchronize()
        print(json.dumps({"sweep": "k3", "grid": z, "rows": rows,
                          "blocks": tl.blocks,
                          "equal": bits_equal(torch, out, want3),
                          **times(k3), "card": card}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
