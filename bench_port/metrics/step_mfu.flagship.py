"""The whole step's share of the H100's float32 peak (67 TFLOP/s), in
percent."""

from bench_port.lib import readers

read = readers.mfu_pct
