"""Device ms a step of the fit step's bank gather (stage ``gather``),
from the program's stage clock."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "fit.step", ("gather",))
