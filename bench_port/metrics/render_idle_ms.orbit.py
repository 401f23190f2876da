"""Device idle ms a traced frame while the host is in the program's
``posed.render`` span or one of its children."""

from bench_port.lib import spans

RENDER = ("posed.render", "posed.prepare", "graph.replay", "posed.clone",
          "posed.check_diag")


def read(run):
    return spans.idle_ms(run, RENDER)
