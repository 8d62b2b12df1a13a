"""call_gap_share.serve: the share of the untraced window's time in which the
device idled between consecutive calls with no re-open between them, in %:
each call's device-idle time since the previous call ended (the previous
call's end event to this call's start event; the caller's copies lie in
it), summed over the window's calls that did not capture, from the
program's registry."""
from portbench import registry


def read(ctx):
    w = registry.window(ctx)
    if w is None:
        return None
    gaps = [c["gap_ms"] for c in w["calls"] if not c["captured"]]
    if any(g is None for g in gaps):
        return None
    return 100.0 * sum(gaps) * 1e-3 / w["elapsed_s"]
