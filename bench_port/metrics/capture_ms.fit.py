"""The fit step's CUDA-graph warm-up and recording, in ms: the program's
own span, ``CapturedGraph.capture_ms`` of the step's graph."""


def read(run):
    return run.counters.get("capture_ms")
