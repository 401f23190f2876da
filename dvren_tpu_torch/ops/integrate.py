"""Emission-absorption integration constants.

Counterpart of the constants of ``dvren_tpu/ops/integrate.py``. The
port's only integrator so far is the one inside the fused tile kernel
(:mod:`dvren_tpu_torch.ops.fused_tiles`); the standalone lattice
integrator comes with the general paths (ROADMAP Queue 1 item 4).
"""

STOP_THRESHOLD = 1e-4   # int_cpu.cpp:171: stop once T <= this
OPACITY_EPS = 1e-6      # int_cpu.cpp:224: depth only where opacity > this
