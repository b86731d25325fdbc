"""Seconds from the process's start to the first timed step: imports, the
kernels' build where not yet built, the trainer, the weights and the
traffic, the checked steps and the warm-up."""


def read(ctx):
    return ctx.setup_s
