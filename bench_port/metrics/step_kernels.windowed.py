"""Device kernels a step in the traced stretch (a count that repeats run to
run)."""

from bench_port.lib import readers

read = readers.kernels_per_unit
