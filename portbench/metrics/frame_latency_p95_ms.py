"""frame_latency_p95_ms: the 95th percentile over every frame of the
window, from its frames handed in on the host to its generated frame on
the host (a frame of a K-frame chunk waits for its whole call)."""
import numpy as np


def read(ctx):
    lat = ctx.window["latencies_ms"]
    return float(np.percentile(lat, 95)) if lat else None
