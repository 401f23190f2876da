"""Host seconds to build the merged multi-view tile schedule and the step
around it (the benchmark's clock around ``_scheduled_views`` and
``make_train_step_scheduled``), before the first step."""


def read(run):
    return run.counters.get("schedule_build_s")
