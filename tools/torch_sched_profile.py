#!/usr/bin/env python3
"""Where the host time of a tile schedule build goes, on this machine.

    python3 tools/torch_sched_profile.py [--top N]

Builds ``chip_smoke.py``'s dense headline schedule (512^2 rays, 64^3,
128 stratified steps) at 16 px, then the moving-camera renderer's
``all_tiles`` schedule of its base pose, each with the native scheduler
core and with ``DVREN_NATIVE_SCHED=0``, under ``cProfile``; prints each
build's wall seconds and its top functions by own time. Host only: the
schedule is numpy, so no card is needed and none is used.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repo root in place of tools/, whose profile.py would shadow the
# standard module cProfile imports
sys.path[0] = HERE

import argparse  # noqa: E402
import cProfile  # noqa: E402
import io  # noqa: E402
import pstats  # noqa: E402
import time  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args()

    import chip_smoke as cs
    import dvren_tpu_torch as P
    from dvren_tpu_torch import native
    from dvren_tpu_torch.render import animate, tiled

    native.library()
    plan, config = cs.headline_scene(P)
    field = P.DenseGridField.create(config, device="cpu")
    mover = animate.MovingCameraRenderer(plan, field)
    builds = {
        "headline_16px": lambda: tiled.build_tiled_schedule(plan, field),
        "orbit_all_tiles": lambda: mover.host_schedule(plan, field)}
    for name, build in builds.items():
        for flag in ("1", "0"):
            os.environ["DVREN_NATIVE_SCHED"] = flag
            build()                                      # warm
            prof = cProfile.Profile()
            t0 = time.perf_counter()
            prof.enable()
            build()
            prof.disable()
            wall = time.perf_counter() - t0
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
                args.top)
            core = "native" if flag == "1" else "numpy"
            print(f"== {name}, {core} builder: {wall:.3f} s wall "
                  f"(profiled)", flush=True)
            lines = out.getvalue().splitlines()
            start = next(i for i, line in enumerate(lines)
                         if line.strip().startswith("ncalls"))
            print("\n".join(lines[start:start + args.top + 1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
