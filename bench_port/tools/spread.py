"""Spreads and medians of runs that ``cells.sh`` recorded.

    python bench_port/tools/spread.py <results.jsonl> [<per-set runs>]

Groups the ``--trace 0`` runs of each cell into consecutive sets of
``per-set runs`` (default 6), and prints for each end-to-end metric each
set's median and spread: the distance between the first and third
quartile (``statistics.quantiles(values, n=4)``) over the median. The
suggested bound is five times the widest spread over the sets and cells,
and never under 1 %. The first run of a cell in a checkout compiles; run
a warm-up before the sets.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv) -> int:
    path = argv[0]
    per = int(argv[1]) if len(argv) > 1 else 6
    runs = defaultdict(list)
    for line in open(path):
        r = json.loads(line)
        if r["trace"] == 0 and r["line"] is not None:
            runs[r["cell"]].append(r)
    widest = defaultdict(float)
    for cell, rs in runs.items():
        sets = [rs[i:i + per] for i in range(0, len(rs), per)]
        for k in rs[0]["line"]["metrics"]:
            parts = []
            for s in sets:
                vals = [r["line"]["metrics"][k]["value"] for r in s]
                sp = spread(vals) if len(vals) >= 2 else float("nan")
                if k != "setup_s":
                    widest[k] = max(widest[k], sp)
                parts.append(f"median {statistics.median(vals):.6g} "
                             f"spread {sp:.4%} (n={len(vals)})")
            print(f"{cell} {k}: " + "; ".join(parts))
        ok = sum(1 for r in rs if r["line"]["correct"])
        print(f"{cell}: {ok} of {len(rs)} runs correct")
    for k, w in widest.items():
        print(f"{k}: widest spread {w:.4%}, bound {max(5 * w, 0.01):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
