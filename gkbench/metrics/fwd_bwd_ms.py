"""Device ms a step of forward and backward (DPTrainStep.local_grads): the
kernels launched inside its range, over the profiled stretch."""

from gkbench.layers import FWD_BWD
from gkbench.stats import layer_ms


def read(ctx):
    return layer_ms(ctx, FWD_BWD)
