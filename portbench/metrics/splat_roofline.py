"""splat_roofline: the splat's bound over its summed device time in the
traced window, its two binning kernels' time included, in %. The bound of
each launch is the larger of its bytes over the HBM rate and its
operations over the f32 peak, at the configuration's `splats` (pyramid
level, channels and launches per training step) for the cell's batch and
dtype. Nothing is read when the accumulating launches in the trace are not
the ones the configuration states."""
import re

from portbench import arith

ACCUMULATE = re.compile(r"\bsplat_accumulate_kernel\b")
ANY = re.compile(r"\bsplat_(accumulate|bin_count|bin_fill)_kernel\b")


def read(ctx):
    tr = ctx.trace_data
    if not tr:
        return None
    shapes = ctx.config["splats"]
    launches = sum(n for _, _, n in shapes)
    accumulate = [1 for _, _, name in tr["device"] if ACCUMULATE.search(name)]
    if len(accumulate) != launches * tr["steps"]:
        return None
    times = sum(end - start for start, end, name in tr["device"] if ANY.search(name))
    batch = tr["units"] // tr["steps"]
    bound = sum(n * arith.splat_bound_s(batch, res, c, ctx.dtype) for res, c, n in shapes)
    return 100.0 * bound * tr["steps"] / times
