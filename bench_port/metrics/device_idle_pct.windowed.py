"""The device's idle share of the traced steps, in percent."""

from bench_port.lib import readers

read = readers.idle_pct
