"""frame_stage_ms.tps: the mean span on the device of the frame step's
`frame.tps` stage per S-stream frame step, in ms (the TPSM prior's
heatmaps, fits, their dense grids and the warps of the source): from the
event node the captured graph records at the stage's start to the next
one (idle between the replay's kernels included), read for the last
replay of the window's sampled calls, from the program's registry. A program or a prior without
the stage gives nothing to read."""
from portbench import registry


def read(ctx):
    return registry.stage_ms(ctx, "frame.tps")
