"""A stand-in for CUDA graph recording on the CPU, for the tests of the
recorded training steps.

On a CUDA device a step is recorded once as a CUDA graph and replayed
(``render/graph.py::capture``). The CPU has no graph to record, so
:func:`installed` puts a stand-in in its place: a recording runs the
function once as a warm-up (which may upload) and once more as the
recorded run, and a replay reruns it (:class:`Rerun`), reading what it
closes over, as a graph reads the addresses it recorded. The recorded run
and every replay may not upload the plan's camera
(``raygen.camera_arrays``) nor read the host jitter table
(``pipeline.plan_jitter_table``), and they take the capture-safe forms
(``ops/grid.py::recording`` is true), as on the card. The CPU Adam keeps
its step count on the host, which a rerun reads anew, so
``check_capturable`` stands aside unless asked to stay.

It patches module attributes itself and undoes them on exit, so pytest's
fixtures and the spawned ranks of tests/torch_parallel_ranks.py (which
inherit no monkeypatch) install it alike. It imports no JAX.
"""

from __future__ import annotations

import contextlib

from dvren_tpu_torch.ops import grid as p_grid
from dvren_tpu_torch.ops import raygen as p_raygen
from dvren_tpu_torch.render import graph as p_graph
from dvren_tpu_torch.render import pipeline as p_pipeline


@contextlib.contextmanager
def patched(*changes):
    """``(obj, name, value)`` set for the duration, then put back."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in changes]
    try:
        for obj, name, value in changes:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


class Rerun:
    """A recorded graph on the CPU: a replay runs the recorded function
    again, as it ran while recorded."""

    def __init__(self, fn, recorded):
        self.fn, self.recorded, self.owner = fn, recorded, None

    def replay(self):
        with self.recorded():
            self.owner.outputs = self.fn()


class Captured(list):
    """The graphs recorded so far, and the row counts of every
    ``accumulate_rows_fixed`` call while recording or replaying."""

    def __init__(self):
        super().__init__()
        self.fixed_forms = []


def _refuse(what):
    def refuse(*args, **kwargs):
        raise AssertionError(f"{what} while recording")
    return refuse


@contextlib.contextmanager
def installed(capturable_check: bool = False):
    """The stand-in in place of ``graph.capture`` (and ``graph.available``
    true on every device and backend) for the duration; yields the
    :class:`Captured` list. ``capturable_check``: keep the real
    ``graph.check_capturable``, which refuses the CPU's Adam."""
    captured = Captured()

    def fixed(dst, idx, rows, _real=p_grid.accumulate_rows_fixed):
        captured.fixed_forms.append(int(idx.numel()))
        return _real(dst, idx, rows)

    def recorded():
        return patched(
            (p_raygen, "camera_arrays",
             _refuse("the plan's camera uploaded")),
            (p_pipeline, "plan_jitter_table",
             _refuse("the host jitter table read")),
            (p_grid, "recording", lambda t: True),
            (p_grid, "accumulate_rows_fixed", fixed))

    def fake_capture(fn, device, before_record=None):
        fn()                                  # the warm-up may upload
        if before_record is not None:
            before_record()
        with recorded():
            outputs = fn()
        g = Rerun(fn, recorded)
        cg = p_graph.CapturedGraph(graph=g, outputs=outputs, launches={},
                                   capture_ms=0.0, fn=fn)
        g.owner = cg
        captured.append(cg)
        return cg

    changes = [(p_graph, "available", lambda device, backend=None: True),
               (p_graph, "capture", fake_capture)]
    if not capturable_check:
        changes.append((p_graph, "check_capturable", lambda optimizer: None))
    with patched(*changes):
        yield captured
