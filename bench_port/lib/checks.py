"""The comparisons that decide ``correct``: the numbers a run compares
with the plain reference, each later held to its limit.

Training (the fit cells), over the first three steps of the very step
object the window drives:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - b1), by the worst leaf: the gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and the median leaf's norm;
- ``change_gap``: the same for the parameters' change after three steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of both (a rule on the
reference's gradient, not on names).

Frames (the orbit): ``image_rms`` and ``opacity_rms``, the root mean
square difference of a sampled frame's RGB and opacity planes from the
reference's render of its pose, the largest over the frames.
"""

from __future__ import annotations

import math
import statistics

TINY_LEAF = 1e-3


def _norm(t) -> float:
    return float(t.double().norm())


def _leaf_gaps(prog, ref, keep):
    med = statistics.median(ref)
    return max((abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30)
                for i in keep), default=math.inf)


def fit_gaps(prog: dict, ref: dict, init) -> dict:
    """``prog`` and ``ref``: {"losses": [3 floats], "grads": [leaf
    tensors], "params": [leaf tensors after three steps]}; ``init`` the
    leaves before the first step."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_ref = [_norm(g) for g in ref["grads"]]
    g_prog = [_norm(g) for g in prog["grads"]]
    med = statistics.median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= TINY_LEAF * med]
    c_ref = [_norm(p - p0) for p, p0 in zip(ref["params"], init)]
    c_prog = [_norm(p - p0) for p, p0 in zip(prog["params"], init)]
    gaps = {"loss_gap": loss_gap,
            "grad_gap": _leaf_gaps(g_prog, g_ref, keep),
            "change_gap": _leaf_gaps(c_prog, c_ref, keep)}
    return {k: (v if math.isfinite(v) else math.inf)
            for k, v in gaps.items()}


def frame_gaps(frames, refs) -> dict:
    """``frames`` and ``refs``: lists of (image (H, W, 3), opacity (H, W))
    pairs, one per sampled frame, in the same order. The root mean square
    of each plane's difference, the largest over the frames."""
    img = op = 0.0
    for (a_img, a_op), (b_img, b_op) in zip(frames, refs):
        d_img = float((a_img.double() - b_img.double()).pow(2).mean().sqrt())
        d_op = float((a_op.double() - b_op.double()).pow(2).mean().sqrt())
        if not (math.isfinite(d_img) and math.isfinite(d_op)):
            return {"image_rms": math.inf, "opacity_rms": math.inf}
        img, op = max(img, d_img), max(op, d_op)
    if not frames:
        return {"image_rms": math.inf, "opacity_rms": math.inf}
    return {"image_rms": img, "opacity_rms": op}


def widest_gap(frames, refs) -> float:
    """The largest absolute difference of any sampled frame's RGB from
    the reference's (reported, not compared: a sample on a face of the
    bbox, inside in one rounding and outside in the other, moves a pixel
    by up to sigma dt there, 3.4e-3)."""
    return max((float((a[0].float() - b[0].float()).abs().max())
                for a, b in zip(frames, refs)), default=math.inf)


def verdict(gaps: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit fails."""
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in gaps.items()}
    ok = all(lim is not None and math.isfinite(v) and v <= lim
             for v, lim in ((d["value"], d["limit"]) for d in out.values()))
    return ok, out
