"""Images trained in the window on all workers, over the window's
seconds (chunk gaps included); a step the guard skipped adds its time and
no samples."""


def read(ctx):
    if not ctx.steps:
        return None
    return (ctx.steps - ctx.skipped) * ctx.global_batch / ctx.window_s
