"""Host seconds of the posed renderer's probe over the orbit's poses
(the program's ``posed.probe`` span)."""

from bench_port.lib import spans


def read(run):
    return spans.span_s(run, "posed.probe")
