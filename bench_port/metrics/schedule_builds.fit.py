"""Host schedule builds in set-up (the program's ``schedule.builds``
counter: one a ``build_tiled_schedule`` call, the cascade's trials
included)."""

from bench_port.lib import spans


def read(run):
    return spans.counter(run, "schedule.builds")
