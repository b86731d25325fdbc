"""EF + select + pack's share of its roofline: the least bytes the layer
must move, (12n + 8k) B (read the gradient and the residual, write the
residual, write k int32 + float32 pairs; ``flops.compress_bytes``), over
the card's published HBM rate (3.35 TB/s on an H100 SXM), divided by
``compress_ms``."""

from gkbench.flops import compress_bytes
from gkbench.layers import COMPRESS
from gkbench.stats import layer_ms


def read(ctx):
    ms = layer_ms(ctx, COMPRESS)
    if not ms or ctx.peaks is None:
        return None
    return 100.0 * compress_bytes(ctx.n, ctx.k) / ctx.peaks[1] / (ms * 1e-3)
