"""The port's profiling utilities on the CPU: `StepTimer` against the JAX
package's on the same clock readings, a `trace` holding an `annotate` span,
and `debug_nans` raising on a NaN made in a backward."""
import json
import math

import pytest
import torch

import mrfa_tpu.utils.profiling as jprofiling
import mrfa_tpu_torch.utils.profiling as profiling


class FakeClock:
    """perf_counter readings of steps lasting 5, 1, 2, 3 and 4 s."""

    def __init__(self):
        self.ticks = iter([0.0, 5.0, 10.0, 11.0, 20.0, 22.0, 30.0, 33.0, 40.0, 44.0])

    def __call__(self):
        return next(self.ticks)


@pytest.mark.parametrize("warmup", [0, 1, 5, 7])
def test_step_timer_matches_jax(monkeypatch, warmup):
    results = []
    for module, timer_cls in ((jprofiling, jprofiling.StepTimer),
                              (profiling, profiling.StepTimer)):
        monkeypatch.setattr(module.time, "perf_counter", FakeClock())
        timer = timer_cls(warmup=warmup)
        for _ in range(5):
            with timer:
                pass
        results.append((timer.count, timer.steps_timed, timer.mean_step_time,
                        timer.throughput(10)))
    want, got = results
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert (math.isnan(g) and math.isnan(w)) or g == w
    if warmup == 1:
        assert got[2] == 2.5 and got[3] == 4.0


def test_step_timer_cpu_device_does_not_synchronize(monkeypatch):
    def no_sync():
        raise AssertionError("synchronized a CPU timer")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    timer = profiling.StepTimer(warmup=0, device="cpu")
    with timer:
        torch.ones(3).sum()
    assert timer.steps_timed == 1 and timer.mean_step_time > 0


def test_trace_holds_annotate_span(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("train_step"):
            (torch.randn(64, 64) @ torch.randn(64, 64)).relu().sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "train_step"]
    assert spans and all(e["dur"] > 0 for e in spans)
    assert any(e.get("name", "").startswith("aten::mm") for e in events)


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
