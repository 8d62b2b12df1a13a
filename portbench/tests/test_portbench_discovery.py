"""The harness finds a cell, its traffic and a metric by name: a workload
file, a traffic file and a metric reader added beside the others are run
and read with no edit of the harness."""
import json

from portbench import harness
from portbench.tests.small import LIVE, ROOT, add_cell, cell_args


def test_an_added_cell_and_metric_are_found(tmp_path, monkeypatch):
    traffic = json.loads((ROOT / "traffic" / "live-s1-f32.json").read_text())
    cell = {**LIVE, "name": "vox1-mtia.live-s2-f32", "traffic": "live-s2-f32"}
    bench = add_cell(tmp_path, monkeypatch, cell,
                     [("calls_in_window",
                       "def read(ctx):\n    return ctx.window['calls']\n")])
    two_streams = {**traffic, "streams": 2}
    (harness.ROOT / "traffic" / "live-s2-f32.json").write_text(json.dumps(two_streams))
    args = cell_args(cell["name"], bench)
    del args["traffic_overrides"]["streams"]  # the added mix's own
    result, lines = harness.run(cell["name"], 11, 0.2, False, **args)
    calls = result["metrics"]["calls_in_window"]["value"]
    assert calls >= 1 and lines[0].startswith(f"window: {calls} calls")
    assert result["attempted"] == 2 * calls  # two streams a call
    assert result["correct"], result["checks"]
    assert "setup_s" in result["metrics"]
    assert "stream_frames_per_s" not in result["metrics"]  # listed for other cells only
