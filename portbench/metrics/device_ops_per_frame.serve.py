"""device_ops_per_frame.serve: device operations (kernels, copies, sets;
graph replays' kernels included) per S-stream frame step of the traced
calls."""


def read(ctx):
    tr = ctx.trace_data
    return len(tr["device"]) / tr["steps"] if tr and tr["steps"] else None
