"""Device ms a frame of the posed build's per-slice run statistics
(stage ``run_stats``: the ``scatter_reduce`` boxes), from the program's
stage clock."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "posed.render", ("run_stats",))
