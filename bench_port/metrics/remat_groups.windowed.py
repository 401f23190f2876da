"""Windowed groups recomputed in a step's backward: the program's
``windowed.remat_groups`` counter over its ``windowed.renders`` (one
render a step)."""

from bench_port.lib import spans


def read(run):
    groups = spans.counter(run, "windowed.remat_groups")
    renders = spans.counter(run, "windowed.renders")
    if not renders:
        return None
    return (groups or 0.0) / renders
