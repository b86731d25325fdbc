"""The whole step's share of the card's dense bf16 peak: the forward and
backward FLOPs of one worker's step (counted at set-up on the reference
model, ``flops.step_flops``) x the window's steps before the profiled
stretch / (their seconds x the published peak, 989.4 TFLOP/s on an H100
SXM)."""


def read(ctx):
    if not ctx.flops_per_step or ctx.peaks is None or ctx.outside_s <= 0:
        return None
    return (100.0 * ctx.flops_per_step * len(ctx.outside)
            / (ctx.outside_s * ctx.peaks[0]))
