"""mfu.serve, mfu.train: the model FLOPs of the window's units (a
stream-frame; a training sample, forward and backward), counted over the
reference at the cell's shapes (the direct algorithm of every convolution
and product), times the window's rate of units, as a share of the card's
peak in the cell's dtype, in %. The rate is the untraced window's, the one
the end-to-end rate reads; the count is made in traced runs only."""
from portbench import arith


def read(ctx):
    if not ctx.trace or not ctx.flops_per_unit or not ctx.window.get("elapsed_s"):
        return None
    rate = ctx.flops_per_unit * ctx.window["units"] / ctx.window["elapsed_s"]
    return 100.0 * rate / arith.PEAK_FLOPS_PER_S[ctx.dtype]
