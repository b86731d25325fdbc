"""The host's time to issue one step: the trainer's ``step_dispatch``
span (the step's call and its trailing synchronise) less its
``step_sync`` (that synchronise, the wait for the device), mean ms a step
over the window's steps before the profiled stretch, from the program's
own store (``--trace on``; ``gkbench/program_spans.py``)."""

from gkbench.program_spans import outside_steps


def read(ctx):
    steps = outside_steps(ctx)
    if not steps:
        return None
    vals = []
    for entry in steps:
        dispatch = entry["ms"].get("step_dispatch")
        wait = entry["ms"].get("step_sync")
        if dispatch is None or wait is None:
            return None
        vals.append(dispatch - wait)
    return sum(vals) / len(vals)
