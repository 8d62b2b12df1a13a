"""stream_frames_per_s: every stream-frame the window delivered to the host,
over all the time of the window (its calls counted whole)."""


def read(ctx):
    return ctx.window["units"] / ctx.window["elapsed_s"]
