"""Device ms a frame of the posed device build (stages ``raygen``,
``mask``, ``lattice``, ``run_stats``, ``lanes``), from the program's
stage clock in the recorded frame."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "posed.render",
                          ("raygen", "mask", "lattice", "run_stats", "lanes"))
