"""The BatchNorms a step that ran through the program's BatchNorm kernel:
the program's ``bn_kernel`` counter (one a forward launch of kernel B5)
over the window's steps before the profiled stretch, divided by their
count, from the program's own store (``--trace on``;
``gkbench/program_spans.py``). A program without the counter gives
None."""

from gkbench.program_spans import outside_steps


def read(ctx):
    steps = outside_steps(ctx)
    if not steps or not any("bn_kernel" in e["counts"] for e in steps):
        return None
    return sum(e["counts"].get("bn_kernel", 0) for e in steps) / len(steps)
