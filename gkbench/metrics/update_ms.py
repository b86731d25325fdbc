"""Device ms a step of the optimizer and the commit
(DPTrainStep._apply_pairs and _commit): the kernels launched inside its
range, over the profiled stretch."""

from gkbench.layers import UPDATE
from gkbench.stats import layer_ms


def read(ctx):
    return layer_ms(ctx, UPDATE)
