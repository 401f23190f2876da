#!/usr/bin/env python3
"""Time K3, K4, K5a and K5b, the packed-table kernels, on one CUDA card.

    python3 tools/torch_packed_table_times.py [--tree DIR] [--sweep]

Imports ``dvren_tpu_torch`` from DIR (default: this checkout; another
tree's ``git archive``, unpacked under ``_archive/``, times that tree's
kernels with the same script). At 64^3 (``chip_smoke.py``'s headline
field) and at 128^3 (its fine grid, phase 39's grid) it holds K3 and K5a
(bfloat16 and float16) to their plain twins as 32-bit / 16-bit words and
K4 and K5b to theirs bit for bit, on a table gradient drawn from seed 6,
then times each wrapper twice with ``chip_smoke.device_ms`` (the stream
sleeps on the card while the host queues the calls: device time alone)
and twice with ``chip_smoke.cuda_ms`` (back-to-back calls: the host's
cost of issuing them included), beside each kernel's bound (bytes over
3.35 TB/s); each also beside its plain twin and the one PyTorch call
that computes the TPU kernel's function (a transpose:
``stack.t().contiguous()`` of the (32, R) stack, float32 for K3, 16-bit
for K5a; ``rows.t().contiguous()`` of the float32 (R, 32) rows, for K4
and for K5b's widened rows), on the device.

``--sweep`` (this tree, or one whose ``packed_transpose.grad_tiling``
takes ``slot_cols``) also times K4 at other runs and z-chunks, K3 and K5a
at other rows per block, and K5b at other runs and z-chunks in both
16-bit types, each launch bit-checked against the twin, through the C
entry points with the geometry the helpers give for those sizes.

Prints the kernels' ``ptxas`` lines, one JSON line per grid (and per
swept geometry), then the card line. Exits 1 without a card or when a
kernel differs from its twin.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 100
DTYPES = ("bfloat16", "float16")


def bits_equal(torch, a, b) -> bool:
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=HERE,
                        help="the checkout whose dvren_tpu_torch is timed")
    parser.add_argument("--sweep", action="store_true",
                        help="also time the kernels at other geometries")
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
        return n_bytes / cs.peaks.HBM_BYTES_S * 1e3

    for n in (64, 128):
        _, config = cs.headline_scene(P, grid_n=n)
        field = P.DenseGridField.create(config, device=dev)
        sigma, color = field.sigma.detach(), field.color.detach()
        shape = tuple(sigma.shape)
        n_rows = pt.fullpitch_rows(shape)
        gen = torch.Generator(device=dev).manual_seed(6)
        tg = torch.randn((n_rows, 32), generator=gen, device=dev)
        table = pt.build_rows(sigma, color)
        grads = pt.table_grad_to_params(tg, shape)
        torch.cuda.synchronize()
        equal = {
            "k3": bits_equal(torch, table, pt.build_rows_plain(sigma, color)),
            "k4": all(bits_equal(torch, a, b) for a, b in zip(
                grads, pt.table_grad_to_params_plain(tg, shape)))}
        in_bytes = cs.nbytes(sigma, color)
        stack32 = pt._shift_stack_fullpitch(sigma, color, n_rows)
        row = {
            "grid": n, "card": card, "equal": equal,
            "k3": {**times(lambda: pt.build_rows(sigma, color)),
                   "plain_ms": cs.device_ms(
                       torch, lambda: pt.build_rows_plain(sigma, color), 10),
                   "library_ms": cs.device_ms(
                       torch, lambda: stack32.t().contiguous(), ITERS)},
            "k4": {**times(lambda: pt.table_grad_to_params(tg, shape)),
                   "plain_ms": cs.device_ms(
                       torch, lambda: pt.table_grad_to_params_plain(
                           tg, shape), 10),
                   "library_ms": cs.device_ms(
                       torch, lambda: tg.t().contiguous(), ITERS)},
            "bound_ms": {"k3": bound_ms(in_bytes + cs.nbytes(table)),
                         "k4": bound_ms(cs.nbytes(tg, *grads))}}
        tg16 = {}
        for name in DTYPES:
            dt = getattr(torch, name)
            tg16[name] = tg.to(dt)
            table16 = pt.build_rows16(sigma, color, dt)
            grads16 = pt.table16_grad_to_params(tg16[name], shape)
            torch.cuda.synchronize()
            equal[f"k5a_{name}"] = bits_equal(
                torch, table16, pt.build_rows16_plain(sigma, color, dt))
            equal[f"k5b_{name}"] = all(
                bits_equal(torch, a, b) for a, b in zip(
                    grads16, pt.table16_grad_to_params_plain(tg16[name],
                                                             shape)))
            stack = pt._shift_stack_fullpitch(sigma, color, n_rows).to(dt)
            rows32 = tg16[name].float()
            row[f"k5a_{name}"] = {
                **times(lambda dt=dt: pt.build_rows16(sigma, color, dt)),
                "plain_ms": cs.device_ms(
                    torch, lambda dt=dt: pt.build_rows16_plain(sigma, color,
                                                               dt), 10),
                "library_ms": cs.device_ms(
                    torch, lambda s=stack: s.t().contiguous(), ITERS)}
            row[f"k5b_{name}"] = {
                **times(lambda t=tg16[name]: pt.table16_grad_to_params(
                    t, shape)),
                "plain_ms": cs.device_ms(
                    torch, lambda t=tg16[name]:
                    pt.table16_grad_to_params_plain(t, shape), 10),
                "library_ms": cs.device_ms(
                    torch, lambda r=rows32: r.t().contiguous(), ITERS)}
            row["bound_ms"][f"k5a_{name}"] = bound_ms(
                in_bytes + cs.nbytes(table16))
            row["bound_ms"][f"k5b_{name}"] = bound_ms(
                cs.nbytes(tg16[name], *grads16))
            del stack, rows32, table16, grads16
        del stack32
        print(json.dumps(row), flush=True)
        if not all(equal.values()):
            print(f"a kernel differs from its twin at {n}^3: {equal}",
                  file=sys.stderr)
            return 1
        if args.sweep:
            if not sweep(torch, pt, _build, dev, card, sigma, color, tg,
                         tg16, shape):
                print(f"a swept launch differs from its twin at {n}^3",
                      file=sys.stderr)
                return 1
    print(card, flush=True)
    return 0


def sweep(torch, pt, _build, dev, card, sigma, color, tg, tg16,
          shape) -> bool:
    """K4 at runs 128 / 256 and z-chunks 1-16, K3 at 64-256 rows a block,
    K5a at 64-256 rows, K5b at runs 64-512 and z-chunks 1-16, each
    bit-checked (True when all were equal) and timed once on the device
    and once as issued."""
    import chip_smoke as cs

    lib = _build.library()
    z, y, x = shape
    stream = _build.stream_ptr(dev)
    n_rows = pt.fullpitch_rows(shape)
    ok_all = True

    def timed(fn):
        return {"device_ms": cs.device_ms(torch, fn, ITERS),
                "issued_ms": cs.cuda_ms(torch, fn, ITERS)}

    def report(entry, ok):
        nonlocal ok_all
        ok_all = ok_all and ok
        print(json.dumps({**entry, "grid": z, "equal": ok, "card": card}),
              flush=True)

    want4 = pt.table_grad_to_params_plain(tg, shape)
    d_sigma, d_color = torch.empty_like(want4[0]), torch.empty_like(want4[1])

    def grads_equal(want):
        torch.cuda.synchronize()
        return (bits_equal(torch, d_sigma, want[0])
                and bits_equal(torch, d_color, want[1]))

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
            report({"sweep": "k4", "run": run, "z_chunk": z_chunk,
                    "blocks": tl.blocks, "smem_bytes": tl.smem_bytes,
                    **timed(k4)}, grads_equal(want4))
    want3 = pt.build_rows_plain(sigma, color)
    out = torch.empty_like(want3)
    for rows in (64, 128, 256):
        tl = pt.table_tiling(shape, rows=rows)

        def k3(tl=tl):
            _build.check(lib.dvt_packed_table(
                sigma.data_ptr(), color.data_ptr(), out.data_ptr(),
                z, y, x, n_rows, tl.rows, tl.stride, tl.blocks,
                tl.smem_bytes, stream), "dvt_packed_table")

        out.fill_(float("nan"))
        k3()
        torch.cuda.synchronize()
        report({"sweep": "k3", "rows": rows, "blocks": tl.blocks,
                **timed(k3)}, bits_equal(torch, out, want3))
    del out, want3
    for kind, name in enumerate(DTYPES):
        dt = getattr(torch, name)
        want5a = pt.build_rows16_plain(sigma, color, dt)
        out16 = torch.empty_like(want5a)
        for rows in (64, 128, 256):
            tl = pt.table_tiling(shape, rows=rows)

            def k5a(tl=tl, kind=kind):
                _build.check(lib.dvt_packed_table16(
                    sigma.data_ptr(), color.data_ptr(), out16.data_ptr(),
                    z, y, x, n_rows, kind, tl.rows, tl.stride, tl.blocks,
                    tl.smem_bytes, stream), "dvt_packed_table16")

            out16.fill_(float("nan"))
            k5a()
            torch.cuda.synchronize()
            report({"sweep": "k5a", "dtype": name, "rows": rows,
                    "blocks": tl.blocks, "smem_bytes": tl.smem_bytes,
                    **timed(k5a)}, bits_equal(torch, out16, want5a))
        del out16, want5a
        want5b = pt.table16_grad_to_params_plain(tg16[name], shape)
        t16 = tg16[name]
        for run in (64, 128, 256, 512):
            for z_chunk in (1, 2, 4, 8, 16):
                tl = pt.grad_tiling(shape, run=run, z_chunk=z_chunk,
                                    slot_cols=16)

                def k5b(tl=tl, kind=kind):
                    _build.check(lib.dvt_packed_table16_grad(
                        t16.data_ptr(), d_sigma.data_ptr(),
                        d_color.data_ptr(), z, y, x, kind, tl.run,
                        tl.z_chunk, tl.runs, tl.lead, tl.span, tl.stride,
                        tl.blocks, tl.smem_bytes, stream),
                        "dvt_packed_table16_grad")

                d_sigma.fill_(float("nan"))
                k5b()
                report({"sweep": "k5b", "dtype": name, "run": run,
                        "z_chunk": z_chunk, "blocks": tl.blocks,
                        "smem_bytes": tl.smem_bytes, **timed(k5b)},
                       grads_equal(want5b))
    return ok_all


if __name__ == "__main__":
    sys.exit(main())
