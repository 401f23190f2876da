"""Device ms a step of the backward's slot reduction (stage
``slot_reduce``: K2's slot rows summed per table row), from the program's
stage clock."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "fit.step", ("slot_reduce",))
