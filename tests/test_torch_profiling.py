"""The port's telemetry registry and profiling tools on the CPU: spans
(nesting, parent, self time, the ring's bound, the profiler mirror),
counters and the rule for counts bumped while a CUDA graph captures, the
device timing of calls read without waiting (through stand-in events),
`snapshot()`'s schema, the program's `frame.*` and `train.*` spans in a
profiler trace, and `debug_nans` raising on a NaN made in a backward."""
import json

import pytest
import torch

import mrfa_tpu_torch.utils.profiling as profiling
from mrfa_tpu_torch.ops import launches
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    one_torch_thread, smooth_image, train_cfg,
)


class FakeClock:
    """perf_counter_ns giving the readings passed, in turn."""

    def __init__(self, *ticks):
        self.ticks = iter(ticks)

    def __call__(self):
        return next(self.ticks)


def test_span_nesting_parent_and_self_time(monkeypatch):
    reg = profiling.Registry()
    # outer 0-100, inner 10-40, inner 50-70, leaf 55-60
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        FakeClock(0, 10, 40, 50, 55, 60, 70, 100))
    with reg.span("outer"):
        with reg.span("inner"):
            pass
        with reg.span("inner"):
            with reg.span("leaf"):
                pass
    snap = reg.snapshot()
    assert snap["spans"] == {
        "inner": {"count": 2, "total_ns": 50, "self_ns": 45},
        "leaf": {"count": 1, "total_ns": 5, "self_ns": 5},
        "outer": {"count": 1, "total_ns": 100, "self_ns": 50},
    }
    assert [(r["name"], r["parent"], r["start_ns"], r["end_ns"]) for r in snap["records"]] == [
        ("inner", "outer", 10, 40), ("leaf", "inner", 55, 60), ("inner", "outer", 50, 70),
        ("outer", None, 0, 100)]


def test_a_span_closes_when_its_body_raises():
    reg = profiling.Registry()
    with pytest.raises(ValueError):
        with reg.span("outer"):
            with reg.span("inner"):
                raise ValueError("boom")
    with reg.span("after"):
        pass
    parents = {r["name"]: r["parent"] for r in reg.snapshot()["records"]}
    assert parents == {"inner": "outer", "outer": None, "after": None}


@pytest.mark.parametrize("ring", [1, 3, 8])
def test_the_ring_is_bounded(ring):
    reg = profiling.Registry(ring=ring)
    for i in range(10):
        with reg.span(f"s{i}"):
            pass
    snap = reg.snapshot()
    assert [r["name"] for r in snap["records"]] == [f"s{i}" for i in range(10 - ring, 10)]
    assert sum(a["count"] for a in snap["spans"].values()) == 10  # aggregates keep all


def test_count_adds_and_returns_the_new_value():
    reg = profiling.Registry()
    assert reg.count("a") == 1 and reg.count("a", 4) == 5 and reg.count("b", 2) == 2
    counters = reg.snapshot()["counters"]
    assert counters["a"] == 5 and counters["b"] == 2
    assert {profiling.LAUNCH + k for k in launches.counts()} <= set(counters)


@pytest.mark.parametrize("replays", [0, 1, 3])
def test_counts_bumped_in_a_capture_come_back_at_each_replay(replays):
    """A stand-in graph: its step bumps a counter and a kernel's launch count
    while it captures; capturing runs nothing, each replay runs the step."""
    reg = profiling.Registry()
    kernel = launches.kernels()[0]
    reg.count("graph.other", 7)  # bumped outside: untouched
    before_launches = kernel.launches
    with profiling.CapturedCounts(reg) as captured:
        reg.count("step.calls", 2)
        kernel.launches += 6
    assert reg.counters["step.calls"] == 0 and kernel.launches == before_launches
    assert captured.delta["step.calls"] == 2
    assert captured.delta[profiling.LAUNCH + kernel.name] == 6
    for _ in range(replays):
        captured.replay()
    assert reg.counters["step.calls"] == 2 * replays
    assert kernel.launches - before_launches == 6 * replays
    assert reg.counters["graph.other"] == 7


def test_the_profiler_mirror_runs_only_under_a_profiler(monkeypatch):
    reg = profiling.Registry()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with reg.span("quiet"):
        pass
    assert reg.snapshot()["spans"]["quiet"]["count"] == 1


class _Event:
    """A stand-in CUDA timing event: `record` stamps the shared clock; it is
    done once the device has passed its stamp."""

    clock = 0.0  # the stand-in device's ms
    done_until = 0.0
    made = []

    def __init__(self, enable_timing=False, external=False):
        self.at = None
        _Event.made.append(self)

    def record(self):
        self.at = _Event.clock

    def query(self):
        return self.at is not None and self.at <= _Event.done_until

    def elapsed_time(self, end):
        assert self.query() and end.query(), "read before the device was done"
        return end.at - self.at


@pytest.fixture
def events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "made", [])
    monkeypatch.setattr(_Event, "clock", 0.0)
    monkeypatch.setattr(_Event, "done_until", 0.0)
    return _Event


def _stepped(stages, reg, ms):
    """One stand-in step of stages taking `ms` each, timed by `stages`."""
    with stages.timing(reg):
        for name, took in zip(("frame.keypoints", "frame.refine"), ms):
            with reg.stage(name):
                _Event.clock += took


def test_calls_are_read_without_waiting_and_gaps_skip_a_capture(events, monkeypatch):
    monkeypatch.setattr(profiling, "STAGE_EVERY", 2)  # a graph's calls 0, 2, 4 are sampled
    reg = profiling.Registry()
    dev = torch.device("cuda", 0)
    stages = profiling.StageEvents()
    _stepped(stages, reg, (1.0, 1.0))  # the capture's warm-up
    events.clock = 10.0

    def call(captured, ms, after, graph=stages):
        with reg.call(dev, 1, captured, graph):
            _stepped(graph, reg, ms)
        events.clock += after

    call(True, (2.0, 3.0), after=4.0)  # 10 -> 15, then 4 idle
    assert reg.snapshot()["calls"] == []  # the device has not finished it
    events.done_until = 15.0
    call(False, (1.0, 0.5), after=0.0)  # 19 -> 20.5: reads the first's stages at its start
    assert reg.calls[0].stages_ms == {"frame.keypoints": 2.0, "frame.refine": 3.0}
    assert len(reg.snapshot()["calls"]) == 1  # the second is not done
    call(False, (2.0, 2.0), after=1.0)  # 20.5 -> 24.5, not done when the next replays:
    call(False, (1.0, 1.0), after=0.0)  # 25.5 -> 27.5; its stages are dropped
    call(False, (3.0, 1.0), after=0.0)  # 27.5 -> 31.5, read by the snapshot
    call(True, (1.0, 1.0), after=0.0, graph=profiling.StageEvents())  # a new capture
    events.done_until = 100.0
    calls = reg.snapshot()["calls"]
    assert [c["device_ms"] for c in calls] == [5.0, 1.5, 4.0, 2.0, 4.0, 2.0]
    assert [c["gap_ms"] for c in calls] == [None, 4.0, 0.0, 1.0, 0.0, None]
    assert [c["stages_ms"] for c in calls] == [
        {"frame.keypoints": 2.0, "frame.refine": 3.0}, None, None, None,
        {"frame.keypoints": 3.0, "frame.refine": 1.0},
        {"frame.keypoints": 1.0, "frame.refine": 1.0}]


def test_a_stage_marks_events_only_while_a_step_is_timed(events):
    reg = profiling.Registry()
    stages = profiling.StageEvents()
    with reg.stage("frame.keypoints"):
        pass
    assert events.made == []  # no step timed: a plain span
    _stepped(stages, reg, (1.0, 2.0))
    _stepped(stages, reg, (1.0, 2.0))  # a second step records the same events
    assert stages.names == ["frame.keypoints", "frame.refine", "end"]
    assert len(events.made) == 3 and reg.stage_events is None
    with pytest.raises(RuntimeError, match="stage 0"):
        with stages.timing(reg):
            with reg.stage("frame.decode"):
                pass


def test_snapshot_schema():
    reg = profiling.Registry()
    with reg.span("a"):
        reg.count("c")
    snap = reg.snapshot()
    assert list(snap) == ["spans", "counters", "records", "calls"]
    assert set(snap["spans"]["a"]) == {"count", "total_ns", "self_ns"}
    assert set(snap["records"][0]) == {"name", "parent", "start_ns", "end_ns"}
    assert all(isinstance(v, int) for v in snap["counters"].values())
    json.dumps(snap)  # plain data


def test_trace_holds_annotate_span(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("train_step"):
            (torch.randn(64, 64) @ torch.randn(64, 64)).relu().sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "train_step"]
    assert spans and all(e["dur"] > 0 for e in spans)
    assert any(e.get("name", "").startswith("aten::mm") for e in events)


FRAME_SPANS = ("frame.keypoints", "frame.dense_motion", "frame.levels", "frame.refine",
               "frame.decode") + tuple(f"refine.{i}" for i in range(6))
TRAIN_SPANS = ("train.step", "train.forward", "train.backward", "train.update")


def test_a_profiler_trace_holds_the_frame_and_train_spans(tmp_path):
    """A 64 px `animate_frame` and a 64 px `train_step` under `trace`: every
    stage of the frame step, each refinement, and the training step's parts
    in the trace, nested as the program opens them."""
    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.train.trainer import Trainer

    torch.manual_seed(0)
    cfg = train_cfg(64)
    cfg["train_params"]["loss_weights"]["perceptual"] = [0] * 5  # no VGG19
    model = MRFA(cfg, device="cpu")
    animator = Animator(model, model.state_dict(), device="cpu")
    trainer = Trainer(cfg, device="cpu", weights=model.state_dict())
    frames = smooth_image(2, 64, seed=1)
    state = animator.begin(frames[0], frames[1])
    batch = {"source": frames[:1], "driving": frames[1:]}
    before = profiling.snapshot()["spans"]
    with profiling.trace(str(tmp_path / "trace")):
        animator.animate_frame(state, frames[1])
        trainer.train_step(batch)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    for name in FRAME_SPANS:  # once in the frame step, once in the training forward
        assert len(spans.get(name, ())) == (1 if name in FRAME_SPANS[:2] else 2), name
    for name in TRAIN_SPANS:
        assert len(spans.get(name, ())) == 1, name
    (step,) = spans["train.step"]
    for name in TRAIN_SPANS[1:]:
        assert step[0] <= spans[name][0][0] and spans[name][0][1] <= step[1], name
    fwd = spans["train.forward"][0]
    assert fwd[0] <= spans["frame.refine"][1][0] <= spans["frame.refine"][1][1] <= fwd[1]
    after = profiling.snapshot()["spans"]
    assert after["train.step"]["count"] - before.get("train.step", {"count": 0})["count"] == 1
    assert "train.allreduce" not in spans  # no group


def test_debug_nans_raises_in_backward():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    try:
        profiling.debug_nans(True)
        assert torch.is_anomaly_enabled()
        y = torch.sqrt(x) * 0.0  # sqrt'(0) = inf, times 0: a NaN in the backward
        with pytest.raises(RuntimeError, match="nan"):
            y.sum().backward()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()
    x.grad = None
    (torch.sqrt(x) * 0.0).sum().backward()  # off: the NaN passes silently
    assert torch.isnan(x.grad[0])
