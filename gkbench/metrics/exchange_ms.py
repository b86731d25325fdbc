"""Device ms a step of the exchange (the step mesh's gather: the NCCL all-
gather of the pairs): the kernels launched inside its range, over the
profiled stretch."""

from gkbench.layers import EXCHANGE
from gkbench.stats import layer_ms


def read(ctx):
    return layer_ms(ctx, EXCHANGE)
