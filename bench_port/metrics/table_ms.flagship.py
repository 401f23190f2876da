"""Device ms a step of the flagship step's table stages (``table`` +
``table_grad``: the supercell table and its adjoint), from the program's
stage clock."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "fit.step", ("table", "table_grad"))
