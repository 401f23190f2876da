"""Device kernels a frame in the traced stretch."""

from bench_port.lib import readers

read = readers.kernels_per_unit
