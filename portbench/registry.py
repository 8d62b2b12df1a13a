"""The program's telemetry registry (`mrfa_tpu_torch.utils.profiling`) as
the per-layer readers of a serving window see it.

The readers pick the window's own records by count: a serving window starts
with a re-open, holds `steps / clip_frames` whole rounds (one re-open and
one graph capture each) and its calls, and no call into the program follows
it, so its records are the registry's newest. A program without the
registry, or a registry whose newest records do not hold the window (too
few, or not one capture a round), gives nothing to read.
"""
from __future__ import annotations

from typing import Optional

STAGES = ("frame.keypoints", "frame.dense_motion", "frame.levels", "frame.refine",
          "frame.decode")


def snapshot() -> Optional[dict]:
    from mrfa_tpu_torch.utils import profiling

    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else None


def window(ctx, snap: Optional[dict] = None) -> Optional[dict]:
    """The window's rounds, calls (device-timed, oldest first) and the
    records of its re-opens (`server.open_streams`) and captures
    (`graph.capture`), or None."""
    win, clip = ctx.window, ctx.traffic.get("clip_frames")
    calls_n, steps = win.get("calls"), win.get("steps")
    if not calls_n or not steps or not clip or steps % clip or not win.get("elapsed_s"):
        return None
    rounds = steps // clip
    snap = snapshot() if snap is None else snap
    if snap is None or len(snap["calls"]) < calls_n:
        return None
    calls = snap["calls"][-calls_n:]
    if sum(c["captured"] for c in calls) != rounds or len({c["capture"] for c in calls}) != rounds:
        return None
    spans = {}
    for name in ("server.open_streams", "graph.capture"):
        records = [r for r in snap["records"] if r["name"] == name][-rounds:]
        if len(records) < rounds:
            return None
        spans[name] = records
    return {"rounds": rounds, "calls": calls, "spans": spans, "elapsed_s": win["elapsed_s"]}


def span_s(record: dict) -> float:
    return (record["end_ns"] - record["start_ns"]) * 1e-9


def stage_ms(ctx, stage: str, snap: Optional[dict] = None) -> Optional[float]:
    """The mean ms of `stage` per frame step over the window's calls' stage
    samples (a sampled call's last replay): the stage's span on the device
    between the graph's event nodes, idle inside the replay included."""
    w = window(ctx, snap)
    if w is None:
        return None
    samples = [c["stages_ms"][stage] for c in w["calls"]
               if c["stages_ms"] is not None and stage in c["stages_ms"]]
    return sum(samples) / len(samples) if samples else None
