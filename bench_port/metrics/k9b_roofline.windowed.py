"""K9b's share of its roofline in the windowed step: its frozen byte count
a step at 3.35 TB/s over its device ms a step, in percent."""

from bench_port.counts import windowed as W
from bench_port.lib import readers


def read(run):
    return readers.roofline_pct(run, W.K9B, "k9b_bytes")
