"""corr_lookup_roofline: the lookup forward kernel's bound over its summed
device time in the traced window, in %. The bound of each launch is the
larger of its bytes over the HBM rate and its operations over the f32 peak,
at the launch's query count (the configuration's `lookups`, per sample and
frame step, times the streams) and the cell's dtype. Nothing is read when
the launches in the trace are not the ones the configuration states."""
import re

from portbench import arith

KERNEL = re.compile(r"\bcorr_lookup_kernel\b")


def read(ctx):
    tr = ctx.trace_data
    if not tr:
        return None
    times = [end - start for start, end, name in tr["device"] if KERNEL.search(name)]
    per_step = ctx.config["lookups"]
    launches = sum(n for _, n in per_step["per_step"])
    if not times or len(times) != launches * tr["steps"]:
        return None
    samples = tr["units"] // tr["steps"]
    bound = sum(n * arith.lookup_bound_s(bq * samples, per_step["map_side"], ctx.dtype)
                for bq, n in per_step["per_step"])
    return 100.0 * bound * tr["steps"] / sum(times)
