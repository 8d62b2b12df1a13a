"""graph_capture_ms.serve: the mean host time of the window's captures of the
frame step (`graph.capture`: the eager warm-up steps and the capture), in
ms, from the program's registry."""
from portbench import registry


def read(ctx):
    w = registry.window(ctx)
    if w is None:
        return None
    records = w["spans"]["graph.capture"]
    return 1e3 * sum(registry.span_s(r) for r in records) / len(records)
