"""What the per-layer readers share: each ``metrics/<name>.py`` is one
call of these on the run it is handed (``run.trace``, the reduced
profiler stretch or None; ``run.counters``, the driver's counters).
A reader that finds nothing to read returns None."""

from bench_port.lib import kernels as K


def per_unit(run, seconds: float) -> float | None:
    """``seconds`` of the traced stretch per step or frame traced."""
    if run.trace is None or not run.trace.units:
        return None
    return seconds / run.trace.units


def roofline_pct(run, pattern: str, counter: str) -> float | None:
    """A kernel's byte bound (``run.counters[counter]`` bytes a step at
    the HBM rate) over its device seconds a step, in percent; None where
    the trace holds none of it."""
    if run.trace is None or run.counters.get(counter) is None:
        return None
    secs = per_unit(run, run.trace.kernel_s(pattern))
    if not secs:
        return None
    return run.counters[counter] / K.HBM_BYTES_S / secs * 100.0


def idle_pct(run):
    """The device's idle share of the traced stretch: 1 - the union of
    device operations over the stretch, in percent."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0


def kernels_per_unit(run):
    """Device kernels in the traced stretch over the steps or frames
    traced."""
    t = run.trace
    if t is None or not t.units or not t.kernels:
        return None
    return len(t.kernels) / t.units


def mfu_pct(run):
    """The whole step's share of the float32 peak: the tile kernels'
    float operations a step (``step_ops``, a frozen count over the live
    samples) over the traced stretch's seconds a step, in percent."""
    ops = run.counters.get("step_ops")
    if run.trace is None or not ops:
        return None
    secs = per_unit(run, run.trace.window_s)
    if not secs:
        return None
    return ops / K.F32_FLOPS / secs * 100.0


def k1_roofline(run):
    return roofline_pct(run, K.K1, "k1_bytes")


def k2_roofline(run):
    return roofline_pct(run, K.K2, "k2_bytes")
