"""Device ms a step of the row gathers' adjoint (stage ``eval_grad``: the
segment sums of the samples' cotangents into the stencil rows), from the
program's stage clock."""

from bench_port.lib import spans


def read(run):
    return spans.stage_ms(run, "fit.step", ("eval_grad",))
