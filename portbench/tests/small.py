"""The cells cut to a size a CPU test holds: 64 px, 3-block hourglasses, a
one-layer TokenPose, the loss pyramid at two scales; every width as in the
configuration files."""
from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
SIZE = 64

TRAFFIC = {
    "serve_chunk": {"frame_size": SIZE, "streams": 2, "chunk": 2, "clip_frames": 4, "rounds": 2,
                    "warmup_calls": 1, "check_steps": 3, "trace_calls": 1},
    "animate_frame": {"frame_size": SIZE, "streams": 1, "clip_frames": 4, "warmup_calls": 1,
                      "check_steps": 3, "trace_calls": 1},
    "train_step": {"frame_size": SIZE, "batch": 2, "bank": 4, "trace_calls": 1},
}


def model_cfg(config: str, blocks: int = 3) -> dict:
    cfg = copy.deepcopy(json.loads((ROOT / "configs" / f"{config}.json").read_text())["model"])
    for key in ("dense_motion", "fomm_kp_detector", "tpsm_dense_motion"):
        cfg[key]["num_blocks"] = blocks
    for key in ("driving_encoder", "source_encoder"):
        cfg["raft_flow"][key]["num_blocks"] = blocks
    cfg["raft_flow"]["size"] = SIZE
    m = cfg["mtia_kp_detector"]["MODEL"]
    m["TRANSFORMER_DEPTH"] = 1
    m["IMAGE_SIZE"] = [SIZE, SIZE]
    cfg["train_params"]["scales"] = [1, 0.25]
    return cfg


def cell_args(cell: str, bench: dict = BENCH) -> dict:
    """harness.run's keyword arguments for `cell` cut to the CPU size."""
    from portbench import harness

    spec = next(c for c in bench["workloads"] if c["name"] == cell)
    entry = harness.load_json(harness.ROOT / "traffic" / f"{spec['traffic']}.json")["entry"]
    return {"model_cfg": model_cfg(spec["config"]), "traffic_overrides": dict(TRAFFIC[entry]),
            "device": "cpu", "bench": bench}


# cells left out of BENCHMARK.json (their runs spread too widely for a
# bound, PERF.md), with the limits their readings gave; the tests add them
# beside the others to hold the `animate_frame` and `train_step` entries
LIVE = {"name": "vox1-mtia.live-s1-f32", "config": "vox1-mtia", "traffic": "live-s1-f32",
        "chips": 1, "why": "one client closed loop, 256 px f32 eager animate_frame",
        "control": "tf32", "limits": {"frame_mean_abs": 5e-6, "worst_frame_mean_abs": 1e-5}}
TRAINING = [{"name": f"{config}.train-b10-f32", "config": config, "traffic": "train-b10-f32",
             "chips": 1, "why": "batch 10 pairs at 256 px, f32 with TF32 off, back to back",
             **json.loads((ROOT / "workloads" / f"{config}.train-b10-f32.json").read_text())}
            for config in ("vox1-mtia", "vox1-tpsm")]
LEFT_OUT = [LIVE] + TRAINING


def add_cell(tmp_path, monkeypatch, cells, metrics=()) -> dict:
    """A copy of the benchmark's files under `tmp_path` with `cells` (one
    cell or a list) added (their workload files written, the harness
    pointed at the copy) -> the BENCHMARK.json object with the cells and
    `metrics` (end-to-end entries, read by the source given, for the first
    cell) added."""
    import shutil

    from portbench import harness

    cells = [cells] if isinstance(cells, dict) else list(cells)
    root = tmp_path / "portbench"
    for d in ("configs", "traffic", "workloads", "metrics", "entries"):
        shutil.copytree(ROOT / d, root / d)
    bench = copy.deepcopy(BENCH)
    for cell in cells:
        (root / "workloads" / f"{cell['name']}.json").write_text(json.dumps(
            {k: cell[k] for k in ("control", "limits")}))
        bench["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips",
                                                        "why")})
    cell = cells[0]
    for name, source in metrics:
        (root / "metrics" / f"{name}.py").write_text(source)
        bench["end_to_end"].append({"name": name, "unit": "n", "better": "higher",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": [cell["name"]]})
    monkeypatch.setattr(harness, "ROOT", root)
    return bench
