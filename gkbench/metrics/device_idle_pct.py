"""100 x the share of the profiled stretch in which no kernel, memcpy or
memset runs on the card."""


def read(ctx):
    s = ctx.summary
    if s is None or not s.busy_s or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
