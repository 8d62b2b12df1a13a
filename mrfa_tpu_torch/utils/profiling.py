"""The port's telemetry: spans, counters and the device time of the captured
frame step, always on and kept in memory for the whole process; and the
operator's tools.

  - `span(name)`: a named, timed region of the host's work. Each closed span
    leaves a record (name, parent span, start and end on
    `time.perf_counter_ns`) in a bounded ring, and adds to its name's count,
    total and self time (the total less its child spans). While a
    `torch.profiler` is active it is also a `record_function` of the same
    name, so the program's spans sit on the device trace's clock;
  - `stage(name)`: a span that opens a stage of the frame step. While a
    `StageEvents` times a step (`FrameGraph` at warm-up and capture), each
    stage's start, and the step's end, also record a CUDA timing event;
  - `count(name, n=1)`: counters;
  - `CapturedCounts`: the rule for counts bumped while a CUDA graph captures
    (the registry's counters and the kernels' launches, `ops/launches.py`):
    the capture ran nothing, so they are taken back, and a replay adds them;
  - `Registry.call`: the device timing of one `animate_chunk` call, read
    later without waiting for the device: the call's device time, the
    device's idle time since the previous call on its device ended, and,
    on one call of a graph in `STAGE_EVERY`, the stage times of its last
    replay;
  - `snapshot()`: all of it as plain dicts, for readers and operators;
  - `trace(logdir)`: a Chrome trace of the host and the card;
  - `debug_nans(enable)`: autograd's anomaly mode.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from mrfa_tpu_torch.ops import launches

RING = 16384  # span records kept (a serving window's rounds hold a few thousand)
CALLS = 8192  # device-timed calls kept
STAGE_EVERY = 8  # a graph's calls of which one keeps its stage times (its first among them)
LAUNCH = "launch."  # a kernel's launch count in `snapshot()`'s counters

_profiler_enabled = torch._C._autograd._profiler_enabled


class StageEvents:
    """CUDA timing events at the stage boundaries of one frame step, owned by
    the step's `FrameGraph`: while `timing()` is open, each `stage` records
    one at its start and the step's end records the last. Every timed step
    records the same events again, so a graph captured under `timing()`
    re-records them at each replay (external event-record nodes), and the
    stage times read from them are the last replay's. Each stage's time is
    its span on the device between two event nodes: idle between its
    kernels included."""

    def __init__(self):
        self.names: List[str] = []
        self.events: List[torch.cuda.Event] = []
        self.calls = 0  # device-timed calls that replayed them
        self.sampled: Optional["DeviceCall"] = None  # the call whose times they hold, unread
        self._next = 0

    def mark(self, name: str) -> None:
        i = self._next
        if i == len(self.events):
            self.names.append(name)
            self.events.append(torch.cuda.Event(enable_timing=True, external=True))
        elif self.names[i] != name:
            raise RuntimeError(f"stage {i} was {self.names[i]!r}, now {name!r}")
        self.events[i].record()
        self._next = i + 1

    @contextlib.contextmanager
    def timing(self, registry: Optional["Registry"] = None):
        """Time the stages of the step run inside, on the current stream."""
        registry = registry or REGISTRY
        self._next = 0
        registry.stage_events = self
        try:
            yield self
            self.mark("end")
        finally:
            registry.stage_events = None

    def times_ms(self) -> Dict[str, float]:
        """Each stage's device time, in ms (the events must be done)."""
        ev = self.events
        return {self.names[i]: ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)}


class _Span:
    __slots__ = ("registry", "name", "stage", "parent", "start", "child", "mirror")

    def __init__(self, registry: "Registry", name: str, stage: bool):
        self.registry, self.name, self.stage = registry, name, stage

    def __enter__(self):
        reg = self.registry
        if self.stage and reg.stage_events is not None:
            reg.stage_events.mark(self.name)
        stack = reg._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child = 0
        self.mirror = None
        if _profiler_enabled():
            self.mirror = torch.profiler.record_function(self.name)
            self.mirror.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        reg = self.registry
        reg._stack().pop()
        took = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child += took
        with reg._lock:
            agg = reg.spans.get(self.name)
            if agg is None:
                agg = reg.spans[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += took
            agg[2] += took - self.child
            reg.records.append((self.name, parent.name if parent is not None else None,
                                self.start, end))
        return False


class DeviceCall:
    """One call's device timing, a context around the call's replays: a
    timing event recorded on entry, before anything else, and one on exit;
    the previous call's end event on the same device; on a sampled call the
    graph's stage events, until their times are read."""

    __slots__ = ("capture", "captured", "start", "end", "prev_end", "stages", "stages_ms",
                 "_times")

    def __init__(self, capture: int, captured: bool, prev_end):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        self.end = torch.cuda.Event(enable_timing=True)
        self.capture, self.captured, self.prev_end = capture, captured, prev_end
        self.stages: Optional[StageEvents] = None
        self.stages_ms: Optional[Dict[str, float]] = None
        self._times: Optional[dict] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end.record()
        return False

    def read_stages(self) -> None:
        """Read the stage times if the call is done, else drop them: another
        call is about to replay the graph and overwrite them."""
        if self.stages is not None and self.end.query():
            self.stages_ms = self.stages.times_ms()
        self.stages = None

    def times(self) -> Optional[dict]:
        """The call's timing once the device has done it, else None."""
        if self._times is None and self.end.query():
            self.read_stages()
            self._times = {
                "capture": self.capture,
                "captured": self.captured,
                "device_ms": self.start.elapsed_time(self.end),
                "gap_ms": self.prev_end.elapsed_time(self.start) if self.prev_end is not None
                else None,
                "stages_ms": self.stages_ms,
            }
        return self._times


class Registry:
    """Spans, counters and device-timed calls of one process (`REGISTRY`);
    tests make their own."""

    def __init__(self, ring: int = RING):
        self.spans: Dict[str, List[int]] = {}  # name -> [count, total_ns, self_ns]
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.records = collections.deque(maxlen=ring)  # (name, parent, start_ns, end_ns)
        self.calls = collections.deque(maxlen=CALLS)  # DeviceCalls, oldest first
        self.stage_events: Optional[StageEvents] = None  # the step being timed
        self._last_end: Dict[torch.device, torch.cuda.Event] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str) -> _Span:
        return _Span(self, name, False)

    def stage(self, name: str) -> _Span:
        return _Span(self, name, True)

    def count(self, name: str, n: int = 1) -> int:
        """Add `n` to the counter `name` -> its new value."""
        with self._lock:
            self.counters[name] += n
            return self.counters[name]

    def counts(self) -> Dict[str, int]:
        """The counters and the kernels' launches (`launch.<kernel>`)."""
        with self._lock:
            out = dict(self.counters)
        out.update({LAUNCH + k: n for k, n in launches.counts().items()})
        return out

    def add_counts(self, delta: Dict[str, int], times: int = 1) -> None:
        """Add `delta` (as `counts()` names them) `times` times."""
        with self._lock:
            for k, n in delta.items():
                if not k.startswith(LAUNCH):
                    self.counters[k] += times * n
        launches.add({k[len(LAUNCH):]: n for k, n in delta.items() if k.startswith(LAUNCH)},
                     times)

    def call(self, device: torch.device, capture: int, captured: bool,
             stages: StageEvents) -> DeviceCall:
        """The device timing of a call of the graph `capture` on the current
        stream of `device` (`captured`: the graph was captured in this call,
        so the time since the previous call holds a re-open), to wrap the
        call's replays in. Reads nothing but the stage times that its replays
        would overwrite, on one call in `STAGE_EVERY`; `snapshot()` reads the
        rest."""
        rec = DeviceCall(capture, captured, None if captured else self._last_end.get(device))
        self._last_end[device] = rec.end
        if stages.sampled is not None:
            stages.sampled.read_stages()
            stages.sampled = None
        if stages.calls % STAGE_EVERY == 0:
            rec.stages, stages.sampled = stages, rec
        stages.calls += 1
        self.calls.append(rec)
        return rec

    def snapshot(self) -> dict:
        """{"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
        {name: n} (kernels' launches as `launch.<kernel>`), "records": [{"name",
        "parent", "start_ns", "end_ns"}] and "calls": [{"capture", "captured",
        "device_ms", "gap_ms", "stages_ms"}], oldest first; the calls up to
        the first the device has not done, read without waiting for it."""
        calls = []
        for rec in list(self.calls):
            times = rec.times()
            if times is None:
                break
            calls.append(dict(times))
        with self._lock:
            spans = {k: {"count": c, "total_ns": t, "self_ns": s}
                     for k, (c, t, s) in self.spans.items()}
            records = [{"name": n, "parent": p, "start_ns": a, "end_ns": b}
                       for n, p, a, b in self.records]
        return {"spans": spans, "counters": self.counts(), "records": records, "calls": calls}


class CapturedCounts:
    """The counts (`Registry.counts()`) bumped while a CUDA graph captured:
    taken back when the capture ends, since capturing ran nothing, and added
    again at each `replay`."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or REGISTRY
        self.delta: Dict[str, int] = {}

    def __enter__(self):
        self._before = self.registry.counts()
        return self

    def __exit__(self, *exc):
        before = self._before
        self.delta = {k: n - before.get(k, 0) for k, n in self.registry.counts().items()}
        self.registry.add_counts(self.delta, -1)
        return False

    def replay(self) -> None:
        self.registry.add_counts(self.delta)


REGISTRY = Registry()
span = REGISTRY.span
stage = REGISTRY.stage
count = REGISTRY.count
snapshot = REGISTRY.snapshot


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed region into
    `logdir`/trace.json (CPU activity always, CUDA when the card is there);
    the program's spans are in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on or off. Unlike `jax_debug_nans`, which
    raises at the first primitive of any computation that makes a NaN, it
    checks the backward: a backward function that returns a NaN raises, with
    the forward operation that made it in the traceback. A NaN made in a
    forward run without autograd is not caught."""
    torch.autograd.set_detect_anomaly(enable)
