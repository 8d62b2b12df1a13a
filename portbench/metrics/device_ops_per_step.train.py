"""device_ops_per_step.train: device operations (kernels, copies, sets)
per training step of the traced calls."""


def read(ctx):
    tr = ctx.trace_data
    return len(tr["device"]) / tr["steps"] if tr and tr["steps"] else None
