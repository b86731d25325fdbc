"""The 95th percentile over every step of the window of rank 0's wall
time a step: the interval between successive step completions, so the
data wait, the trainer's bookkeeping and the log-interval work are in
it."""

from gkbench.stats import p95


def read(ctx):
    q = p95(ctx.walls_s)
    return None if q is None else q * 1e3
