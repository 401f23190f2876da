"""Device ms a step of the windowed step's field evaluation (stage
``eval``: each group's rays, samples and packed-stencil row gathers, a
recomputed group's included), from the program's stage clock."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "fit.step", ("eval",))
