"""Host seconds of the program's ``fit.schedule`` span: the merged
multi-view schedule's build, merge and upload."""

from bench_port.lib import spans


def read(run):
    return spans.span_s(run, "fit.schedule")
