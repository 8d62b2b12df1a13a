"""device_idle_share.serve, device_idle_share.train: the share of the
untraced window's time in which no operation ran on the device, in %: one
less the device's busy time a unit (the union of its operations over the
device-only trace's units) times the window's units, over the window's
time. The profiler lengthens the traced calls themselves, so their own
idle share would read the profiler's cost; the device's busy time a unit
does not move with it. Work the traced calls do not hold (a re-open in
the window) is not counted busy, so the share is an upper bound."""
from portbench import trace


def read(ctx):
    tr, window = ctx.trace_data, ctx.window
    if not tr or not tr["units"] or not window.get("elapsed_s"):
        return None
    busy = trace.busy_s(tr) / tr["units"] * window["units"]
    return 100.0 * (1.0 - busy / window["elapsed_s"])
