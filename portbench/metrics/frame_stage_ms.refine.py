"""frame_stage_ms.refine: the mean span on the device of the frame step's
`frame.refine` stage per S-stream frame step, in ms: from the event node the
captured graph records at the stage's start to the next one (idle between
the replay's kernels included), read for the last replay of the window's
sampled calls, from the program's registry."""
from portbench import registry


def read(ctx):
    return registry.stage_ms(ctx, "frame.refine")
