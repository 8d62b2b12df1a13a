"""setup_s: process start to the first timed call (imports, CUDA's start,
the kernels' load or build, the program and its weights, the inputs, the
warm-up)."""


def read(ctx):
    return ctx.setup_s
