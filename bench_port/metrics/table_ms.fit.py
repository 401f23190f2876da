"""Device ms a step of the fit step's table stages (``table``: K3 or the
supercell table; ``table_grad``: K4 or the supercell table's adjoint),
from the program's stage clock in the recorded step."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "fit.step", ("table", "table_grad"))
