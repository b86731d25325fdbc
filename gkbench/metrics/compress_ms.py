"""Device ms a step of EF accumulate, selection and pack
(DPTrainStep.pack_phase: kernel B1 and its host tail): the kernels
launched inside its range, over the profiled stretch."""

from gkbench.layers import COMPRESS
from gkbench.stats import layer_ms


def read(ctx):
    return layer_ms(ctx, COMPRESS)
