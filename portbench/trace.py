"""The traced calls: `torch.profiler` over a few calls of the cell's entry,
and its reduction to what the per-layer readers read.

A run traces the same number of calls twice. The device-only trace
(`reduce_device`) records the device's operations and nothing of the host,
so that the host runs almost as fast as untraced; the readers read it. The
trace with the host's operators (`reduce`) slows the host by its per-op
records; it only names what the host was doing in each idle gap.

The reductions keep, from the profiler's raw event list:
  - the device operations (kernels, copies, sets) with their start and end,
    without the device-side mirrors of host annotations;
  - with the host: the benchmark's host spans (`record_function` around
    each call into the program, see `SPANS`) and the host's operator events.
Times are seconds from the start of the traced calls.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

# the benchmark's own spans, around its calls into the program's layers
SPANS = ("h2d", "d2h", "serve_chunk", "animate_frame", "train_step", "open_streams")
WINDOW_SPAN = "traced_window"
NAME_CHARS = 160  # a kernel's name in the breakdown (templates run to a thousand)


def _field(e, name: str):
    v = getattr(e, name)
    return v() if callable(v) else v


def _interval_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        start = _field(e, "start_ns")
        return start, start + _field(e, "duration_ns")
    start = _field(e, "start_us") * 1000
    return start, start + _field(e, "duration_us") * 1000


def _is_device(e) -> bool:
    return "CUDA" in str(_field(e, "device_type"))


def _is_annotation(e, host_names) -> bool:
    if hasattr(e, "is_user_annotation") and _field(e, "is_user_annotation"):
        return True
    return _field(e, "name") in host_names


def reduce(prof) -> Dict[str, object]:
    """The device operations, host spans and host operators of a finished
    profile, on one clock from the traced window's start."""
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if not _is_device(e)]
    host_names = {_field(e, "name") for e in host}
    window = [e for e in host if _field(e, "name") == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the traced window's span is missing from the trace")
    w0, w1 = _interval_ns(window[0])

    def rel(iv):
        return ((iv[0] - w0) * 1e-9, (iv[1] - w0) * 1e-9)

    device = sorted((rel(_interval_ns(e)) + (_field(e, "name"),)) for e in events
                    if _is_device(e) and not _is_annotation(e, host_names))
    spans = sorted(rel(_interval_ns(e)) + (_field(e, "name"),) for e in host
                   if _field(e, "name") in SPANS)
    ops = sorted(rel(_interval_ns(e)) + (_field(e, "name"),) for e in host
                 if _field(e, "name").startswith("aten::"))
    return {"window_s": (w1 - w0) * 1e-9, "device": device, "spans": spans, "ops": ops}


def reduce_device(prof, window_s: float) -> Dict[str, object]:
    """The device operations of a device-only profile, on a clock from the
    first one's start; `window_s` is the host's clock around the traced
    calls, which every one of them lies inside."""
    names = set(SPANS) | {WINDOW_SPAN}
    ops = [(_interval_ns(e), _field(e, "name"))
           for e in prof.profiler.kineto_results.events()
           if _is_device(e) and not _is_annotation(e, names)]
    w0 = min((iv[0] for iv, _ in ops), default=0)
    device = sorted(((a - w0) * 1e-9, (b - w0) * 1e-9, name) for (a, b), name in ops)
    return {"window_s": window_s, "device": device, "spans": [], "ops": []}


def busy_intervals(device: List[tuple], window_s: float) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the window."""
    merged: List[List[float]] = []
    for start, end, _ in device:
        start, end = max(start, 0.0), min(end, window_s)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(trace: dict) -> float:
    return sum(b - a for a, b in busy_intervals(trace["device"], trace["window_s"]))


def _covering(intervals: List[tuple], t: float):
    """The name of the latest-starting interval that covers t (None if none)."""
    starts = [iv[0] for iv in intervals]
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        _, end, name = intervals[i]
        if end >= t:
            return name
        i -= 1
    return None


def _latest_before(intervals: List[tuple], t: float):
    starts = [iv[0] for iv in intervals]
    i = bisect.bisect_right(starts, t) - 1
    return intervals[i][2] if i >= 0 else None


def breakdown(trace: dict, host_trace: dict, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (summed by name, from the
    device-only `trace`) and the longest idle gaps of the device (from
    `host_trace`, where the host's records lengthen them), each named by
    the benchmark span the host was in and the host operator it had last
    started."""
    by_name: Dict[str, float] = {}
    for start, end, name in trace["device"]:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    trace = host_trace
    busy = busy_intervals(trace["device"], trace["window_s"])
    edges = [0.0] + [x for iv in busy for x in iv] + [trace["window_s"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        span = _covering(trace["spans"], a) or "outside any span"
        op = _latest_before(trace["ops"], a) or "no host operator"
        named.append([f"{span} / {op}", b - a])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops], "idle_gaps": named}
