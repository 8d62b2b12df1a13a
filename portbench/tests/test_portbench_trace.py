"""The traced run's plumbing on the CPU: the device-only reduction and the
busy union, the readers shared by dotted names, and a serving window of
whole rounds."""
import pytest

from portbench import harness, trace
from portbench.tests.small import BENCH, TRAFFIC, cell_args


class _Event:
    def __init__(self, name, start_ns, duration_ns, device="DeviceType.CUDA"):
        self.name, self.start_ns, self.duration_ns = name, start_ns, duration_ns
        self.device_type, self.is_user_annotation = device, False


class _Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})()})()


def test_the_device_only_reduction_and_its_busy_union():
    events = [_Event("k1", 1_000, 2_000), _Event("k2", 2_000, 3_000),  # overlap: 1-5 us
              _Event("k3", 9_000, 1_000),
              _Event("train_step", 0, 20_000),  # a device mirror of a span: left out
              _Event("aten::add", 500, 100, device="DeviceType.CPU")]
    tr = trace.reduce_device(_Profile(events), window_s=12e-6)
    assert [name for _, _, name in tr["device"]] == ["k1", "k2", "k3"]
    assert tr["device"][0][0] == 0.0  # the clock starts at the first operation
    assert trace.busy_s(tr) == pytest.approx(5e-6)  # 4 us of k1|k2 and 1 us of k3
    gaps = trace.breakdown(tr, {**tr, "spans": [], "ops": []})["idle_gaps"]
    assert [round(s * 1e6, 3) for _, s in gaps] == [4.0, 3.0]  # 4-8 us, then 9-12 us


@pytest.mark.parametrize("name", ["mfu.serve", "mfu.train", "device_idle_share.serve",
                                  "device_idle_share.train"])
def test_a_dotted_name_is_read_by_its_stem(name):
    assert harness.reader(name).read.__module__ == f"portbench_metric_{name}"
    stem = name.split(".")[0]
    assert not (harness.ROOT / "metrics" / f"{name}.py").exists()
    assert (harness.ROOT / "metrics" / f"{stem}.py").exists()


def test_a_traced_serving_run_holds_whole_rounds():
    cell = "vox1-mtia.serve-s8-bf16-graph"
    result, lines = harness.run(cell, 2 ** 33 + 5, 0.3, True, **cell_args(cell, BENCH))
    tr = TRAFFIC["serve_chunk"]
    calls = int(lines[0].split()[1])
    assert calls % (tr["clip_frames"] // tr["chunk"]) == 0
    assert lines[1].startswith("trace: 1 calls")
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert "mfu.serve" in result["metrics"] and result["correct"], result["checks"]
