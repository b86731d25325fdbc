"""The trainer's own ``data_wait`` span (``--trace on``: the batch to the
device and a synchronise), mean ms a step over the window's steps before
the profiled stretch."""

from gkbench.stats import mean_of


def read(ctx):
    return mean_of(ctx.data_wait_ms, ctx.outside)
