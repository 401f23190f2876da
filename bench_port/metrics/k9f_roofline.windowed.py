"""K9f's share of its roofline in the windowed step: its frozen byte count
a step (every launch, the groups' recompute included) at 3.35 TB/s over
its device ms a step, in percent."""

from bench_port.counts import windowed as W
from bench_port.lib import readers


def read(run):
    return readers.roofline_pct(run, W.K9F, "k9f_bytes")
