"""K1's share of its roofline in the step: its frozen byte count at 3.35
TB/s over its device ms a step, in percent."""

from bench_port.lib import readers

read = readers.k1_roofline
