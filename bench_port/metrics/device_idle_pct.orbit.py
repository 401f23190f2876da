"""The device's idle share of the traced frames, in percent."""

from bench_port.lib import readers

read = readers.idle_pct
