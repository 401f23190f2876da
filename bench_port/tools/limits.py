"""The readings a cell's limits are set from, on the card, in one process.

    python bench_port/tools/limits.py --workload <cell> \
        --program-seeds 1,2,... --control-seeds 7,8,9 --seconds 1 \
        --out <file.json>

For each program seed, one run of the cell's driver (its set-up, a short
window, its comparison with the reference): the sound readings, whose
largest is a number's lower reading. For each control seed, the control
and, for a training cell, the planted faults, each put in the program's
place and compared with the float32 reference as a run compares the
program:

- ``control``: the reference in bfloat16 (the field's values, the
  interpolation, the integration, the loss, the gradients and Adam);
- ``half_batch`` (training): the loss over the first half of the views
  only, the mean taken over them;
- ``altered`` (training): 256 rays of view 0's image, from its middle
  row, set to zero where the render produces them;
- a state left unchanged (training) reads 1 by the measure and needs no
  run.

For a frame cell the control renders the poses of the frames a run
compares. The smallest control or fault reading (a fault only where it
reads at least ten times the lower one) is the upper reading.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_port.lib import checks, harness  # noqa: E402
from bench_port.lib import scene as S  # noqa: E402
from bench_port.reference import dense_grid as ref  # noqa: E402

ALTERED_RAYS = 256


def altered(scene):
    """A fault: ``ALTERED_RAYS`` rays of view 0 from its middle row give
    zero radiance."""
    first = (scene.height // 2) * scene.width

    def alter(view, start, rgb):
        if view != 0:
            return rgb
        lo, hi = max(first - start, 0), min(first + ALTERED_RAYS - start,
                                            rgb.shape[0])
        if hi <= lo:
            return rgb
        keep = ref.torch.ones(rgb.shape[0], 1, dtype=rgb.dtype,
                              device=rgb.device)
        keep[lo:hi] = 0
        return rgb * keep

    return alter


def fit_controls(spec: dict, seed: int, device) -> dict:
    torch = ref.torch
    tr, cfg = spec["traffic"], spec["config_spec"]
    sc = S.scene(cfg, tr)
    poses = [S.poses(tr)[i] for i in S.order(len(S.poses(tr)), seed)]
    sigma, color = S.grid(cfg, device)
    targets = torch.stack([ref.render_view(sigma, color, sc, c)[0]
                           for c in poses])
    del sigma, color
    n = int(cfg["grid"]["n"])
    init = [torch.full((n, n, n), float(tr["init"]), device=device),
            torch.full((n, n, n, 3), float(tr["init"]), device=device)]
    lr = float(tr["lr"])
    steps = 3
    r = ref.adam_fit(init[0], init[1], sc, poses, targets, lr, steps)
    half = len(poses) // 2
    out = {
        "control": ref.adam_fit(init[0], init[1], sc, poses, targets, lr,
                                steps, dtype=torch.bfloat16),
        "half_batch": ref.adam_fit(init[0], init[1], sc, poses[:half],
                                   targets[:half], lr, steps),
        "altered": ref.adam_fit(init[0], init[1], sc, poses, targets, lr,
                                steps, alter=altered(sc)),
    }
    return {k: checks.fit_gaps(v, r, init) for k, v in out.items()}


def frame_controls(spec: dict, seed: int, device) -> dict:
    tr, cfg = spec["traffic"], spec["config_spec"]
    sc = S.scene(cfg, tr)
    poses = S.poses(tr)
    sigma, color = S.grid(cfg, device)
    picks = [(seed + 37 * i) % len(poses)
             for i in range(int(tr["check_frames"]))]
    f32 = [ref.render_view(sigma, color, sc, poses[j]) for j in picks]
    bf16 = [ref.render_view(sigma, color, sc, poses[j],
                            dtype=ref.torch.bfloat16) for j in picks]
    return {"control": checks.frame_gaps(bf16, f32)}


def upper_and_limit(lower: dict, readings: list) -> dict:
    """Per number: the lower reading, the upper reading (the least
    control reading, or fault reading of ten times the lower or more;
    the state left unchanged reads 1 and counts at three times), and a
    limit between them nearer the upper in log space."""
    out = {}
    for k, lo in lower.items():
        ups = []
        for name, gaps in readings:
            v = gaps.get(k)
            if v is None or not math.isfinite(v):
                continue
            if name == "control" or v >= 10 * lo:
                ups.append(v)
        if k == "change_gap" and 1.0 >= 3 * lo:
            ups.append(1.0)
        up = min(ups) if ups else None
        lim = None
        if up is not None and up >= 3 * lo and lo > 0:
            lim = float(f"{math.exp(0.35 * math.log(lo) + 0.65 * math.log(up)):.2g}")
        out[k] = {"lower": lo, "upper": up, "limit": lim}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--check-every", type=int, default=0,
                    help="a frame cell's sampling of frames to compare "
                         "(0: the cell's own)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    harness.cache_dirs()
    device = torch.device("cuda", 0)
    spec = harness.workload(args.workload)
    if args.check_every:
        spec["traffic"]["check_every"] = args.check_every
    result = {"cell": args.workload, "card": torch.cuda.get_device_name(0),
              "program": [], "controls": []}
    for seed in (int(s) for s in args.program_seeds.split(",")):
        t = time.perf_counter()
        o = harness.local_run(args.workload, spec, seed, args.seconds, device)
        result["program"].append({"seed": seed, "gaps": o.gaps,
                                  "end_to_end": o.end_to_end,
                                  "attempted": o.attempted,
                                  "wall_s": time.perf_counter() - t})
        print(json.dumps(result["program"][-1]), flush=True)
    frames = spec["driver"] == "orbit"
    for seed in (int(s) for s in args.control_seeds.split(",")):
        t = time.perf_counter()
        got = (frame_controls if frames else fit_controls)(spec, seed, device)
        result["controls"].append({"seed": seed, "readings": got,
                                   "wall_s": time.perf_counter() - t})
        print(json.dumps(result["controls"][-1]), flush=True)
    keys = result["program"][0]["gaps"].keys()
    lower = {k: max(p["gaps"][k] for p in result["program"]) for k in keys}
    readings = [(name, g) for c in result["controls"]
                for name, g in c["readings"].items()]
    result["limits"] = upper_and_limit(lower, readings)
    print(json.dumps(result["limits"]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
