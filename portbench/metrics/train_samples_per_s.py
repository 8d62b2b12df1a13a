"""train_samples_per_s: every sample the window trained on, over all the
time of the window (its steps counted whole)."""


def read(ctx):
    return ctx.window["units"] / ctx.window["elapsed_s"]
