"""The readers of the program's telemetry registry on synthetic snapshots:
each picks the window's own (newest) records by count, and reads nothing
when the registry holds too few records or not one capture a round."""
import pytest

from portbench import harness, registry

NAMES = ["reopen_share.serve", "graph_capture_ms.serve", "call_gap_share.serve"] + [
    f"frame_stage_ms.{s.split('.')[1]}" for s in registry.STAGES]


class _Ctx:
    def __init__(self, calls, steps, elapsed_s, clip_frames=8):
        self.window = {"calls": calls, "steps": steps, "elapsed_s": elapsed_s}
        self.traffic = {"clip_frames": clip_frames, "chunk": 4}


def _snapshot(rounds, calls_a_round=2, old_rounds=1):
    """`old_rounds` rounds before the window (their times 100x the window's,
    so a reader that takes them reads far off), then the window's."""
    records, calls = [], []
    t = 0
    for r in range(old_rounds + rounds):
        big = 100 if r < old_rounds else 1
        for name, ms in (("server.open_streams", 2), ("graph.capture", 3)):
            records.append({"name": name, "parent": None, "start_ns": t,
                            "end_ns": t + big * ms * 1_000_000})
            t += big * ms * 1_000_000
        for i in range(calls_a_round):
            calls.append({"capture": r + 1, "captured": i == 0, "device_ms": 5.0 * big,
                          "gap_ms": None if i == 0 else 0.5 * big,
                          "stages_ms": {s: (k + 1) * big for k, s in enumerate(registry.STAGES)}})
    return {"spans": {}, "counters": {}, "records": records, "calls": calls}


def _read(name, ctx, snap, monkeypatch):
    monkeypatch.setattr(registry, "snapshot", lambda: snap)
    return harness.reader(name).read(ctx)


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_takes_the_window_newest_records(name, monkeypatch):
    # 2 rounds of 8 frames, 2 calls a round (K=4), 1 s of window
    got = _read(name, _Ctx(calls=4, steps=16, elapsed_s=1.0), _snapshot(2), monkeypatch)
    want = {"reopen_share.serve": 100.0 * 2 * (2 + 3) * 1e-3,
            "graph_capture_ms.serve": 3.0,
            "call_gap_share.serve": 100.0 * 2 * 0.5e-3}
    want.update({f"frame_stage_ms.{s.split('.')[1]}": float(k + 1)
                 for k, s in enumerate(registry.STAGES)})
    assert got == pytest.approx(want[name])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["too_few_calls", "captures_do_not_match", "no_registry"])
def test_a_reader_reads_nothing_without_the_window(name, case, monkeypatch):
    ctx = _Ctx(calls=4, steps=16, elapsed_s=1.0)
    snap = _snapshot(2, old_rounds=0)
    if case == "too_few_calls":
        snap["calls"] = snap["calls"][1:]
    elif case == "captures_do_not_match":
        ctx = _Ctx(calls=4, steps=24, elapsed_s=1.0)  # 3 rounds said, 2 captured
    else:
        snap = None
    assert _read(name, ctx, snap, monkeypatch) is None


def test_too_few_re_open_records_read_nothing(monkeypatch):
    snap = _snapshot(2, old_rounds=0)
    snap["records"] = [r for r in snap["records"] if r["name"] != "server.open_streams"][1:]
    assert _read("reopen_share.serve", _Ctx(4, 16, 1.0), snap, monkeypatch) is None


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
    from mrfa_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert registry.snapshot() is None
    assert harness.reader("reopen_share.serve").read(_Ctx(4, 16, 1.0)) is None
