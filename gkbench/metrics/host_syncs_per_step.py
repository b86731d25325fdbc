"""The waits for the device the trainer asks for, a step: the program's
``host_syncs`` counter (each synchronise, each blocking copy of a batch to
the device, each host read of a device tensor in the loop and the step)
over the window's steps before the profiled stretch, divided by their
count, from the program's own store (``--trace on``;
``gkbench/program_spans.py``)."""

from gkbench.program_spans import outside_steps


def read(ctx):
    steps = outside_steps(ctx)
    if not steps or not any("host_syncs" in e["counts"] for e in steps):
        return None
    return sum(e["counts"].get("host_syncs", 0) for e in steps) / len(steps)
