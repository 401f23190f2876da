"""Device idle ms a traced step while the host is in the program's
``graph.replay`` span (the step graph's launch)."""

from bench_port.lib import spans


def read(run):
    return spans.idle_ms(run, ("graph.replay",))
