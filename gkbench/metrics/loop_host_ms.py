"""The trainer loop's own host time, mean ms a step over the window's
steps before the profiled stretch: the wall a step (as in
``step_ms_p95``) less the trainer's ``step_ms`` and its ``data_wait``
span. Records, logging, the throughput tracker and the stop flag are in
it."""

from gkbench.stats import mean_of


def read(ctx):
    wall = mean_of(ctx.walls_s, ctx.outside)
    step = mean_of(ctx.step_ms, ctx.outside)
    wait = mean_of(ctx.data_wait_ms, ctx.outside)
    if None in (wall, step, wait):
        return None
    return wall * 1e3 - step - wait
