"""The benchmark's core, driven by data: a cell of `BENCHMARK.json` names a
configuration (`configs/<config>.json`), a traffic mix
(`traffic/<traffic>.json`, whose `entry` names the driver in
`entries/<entry>.py`) and its own file (`workloads/<cell>.json`: its why
and the limits of its correctness check); every metric is a reader in
`metrics/<metric>.py`. Adding a cell, a configuration, a mix or a metric is
adding files; nothing here names one.

One run: set-up (the program built from weights made from the seed, the
inputs made from the seed, every shape of the cell warmed up), the measured
window (calls back to back until `seconds` have passed, each counted whole),
the program freed, and the check of what the window produced against the
plain reference. With `trace`, `trace_calls` calls before the window run
under `torch.profiler` twice: first tracing the device alone (what the
per-layer readers read: busy time, operations, kernel times), then with
the host's operators too (what names the idle gaps of the breakdown); the
window itself runs untraced, as in every run.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from portbench import trace as tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# a traffic file's dtype -> the port's compute_dtype (None: f32 throughout)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A benchmark file loaded by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, kind: str, cell: str):
    """The metrics of `kind` ("end_to_end" or "per_layer") that `cell` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(name: str):
    """`metrics/<name>.py`, or for a dotted name with no file of its own
    (`mfu.train`) the reader of its stem (`metrics/mfu.py`)."""
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = ROOT / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return load_module(path, f"portbench_metric_{name}")


class Context:
    """What a run's entry and readers see: the cell's files, the seed, the
    device and the run's measurements as they come."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device,
                 bench: dict, model_cfg: Optional[dict] = None,
                 traffic_overrides: Optional[dict] = None):
        self.name, self.seed, self.seconds, self.trace = name, int(seed), seconds, trace
        self.device = torch.device(device)
        self.bench = bench
        self.cell = cell_spec(bench, name)
        self.config = load_json(ROOT / "configs" / f"{self.cell['config']}.json")
        self.traffic = {**load_json(ROOT / "traffic" / f"{self.cell['traffic']}.json"),
                        **(traffic_overrides or {})}
        self.workload = load_json(ROOT / "workloads" / f"{name}.json")
        self.model_cfg = model_cfg if model_cfg is not None else self.config["model"]
        self.dtype = self.traffic["dtype"]
        self.window: Dict[str, object] = {}
        self.trace_data: Optional[dict] = None  # the device-only trace
        self.host_trace: Optional[dict] = None  # the trace with the host's operators
        self.flops_per_unit: Optional[float] = None
        self.setup_s: Optional[float] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def set_precision(config: dict) -> None:
    """TF32 as the configuration states it, for cuBLAS and cuDNN alike."""
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        name, limit = out.strip().splitlines()[0].split(", ")
        return {"smi_name": name, "power_limit_w": float(limit)}
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        return {"power_limit_w": None, "smi_error": str(e)}


def _add(stats: dict, done: dict) -> None:
    stats["calls"] += 1
    stats["units"] += done["units"]
    stats["steps"] += done["steps"]
    stats["latencies_ms"].extend(done.get("latencies_ms", ()))


def _stats() -> dict:
    return {"calls": 0, "units": 0, "steps": 0, "latencies_ms": []}


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, bench: Optional[dict] = None,
        model_cfg: Optional[dict] = None, traffic_overrides: Optional[dict] = None,
        after_check=None):
    """One run of one cell -> (the result line's object, the lines for
    standard error: the window's counts, then each check beside its limit).
    `after_check(ctx, entry)`, when given, runs after the check and its
    dict is kept under the result's "calibration" (`calibrate.py`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench if bench is not None else load_json(REPO / "BENCHMARK.json")
    ctx = Context(name, seed, seconds, trace, device, bench, model_cfg, traffic_overrides)
    set_precision(ctx.config)
    entry = load_module(ROOT / "entries" / f"{ctx.traffic['entry']}.py",
                        f"portbench_entry_{ctx.traffic['entry']}").Entry(ctx)
    entry.setup()
    ctx.sync()
    ctx.setup_s = time.perf_counter() - t_start
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    if trace:  # the device-only trace first: a later session in a process may miss events
        ctx.trace_data = _traced_calls(ctx, entry, host=False)
        ctx.host_trace = _traced_calls(ctx, entry, host=True)
    # an entry whose traffic runs in rounds (re-opens) starts the window at
    # a round's start and ends it at a round's end, so every window holds
    # whole rounds
    if hasattr(entry, "start_window"):
        entry.start_window()
    at_boundary = getattr(entry, "at_boundary", lambda: True)
    stats = _stats()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or not at_boundary():
        _add(stats, entry.call())
    entry.drain()
    ctx.sync()
    stats["elapsed_s"] = time.perf_counter() - t0
    ctx.window = stats
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

    entry.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = entry.check()
    extra = after_check(ctx, entry) if after_check is not None else None
    checks = {}
    correct = bool(ctx.workload["limits"])
    for key, limit in ctx.workload["limits"].items():
        value = readings[key]
        ok = limit is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[key] = {"value": value, "limit": limit}

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, kind, name):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": ctx.cell["chips"], "memory_peak_bytes": peak}
    if ctx.device.type == "cuda":
        dev.update(card())
    result = {"correct": correct, "attempted": stats["units"], "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tracing.busy_s(ctx.trace_data)
        dev["window_s"] = ctx.trace_data["window_s"]
        result["breakdown"] = tracing.breakdown(ctx.trace_data, ctx.host_trace)
    if extra is not None:
        result["calibration"] = {"readings": readings, **extra}
    result["checks"] = checks
    lines = [f"window: {stats['calls']} calls, {stats['units']} units, {stats['steps']} steps, "
             f"{stats['elapsed_s']!r} s, {len(stats['latencies_ms'])} latency samples"]
    if trace:  # what the profiler costs: the traced calls' time against the window's
        lines.append(f"trace: {ctx.trace_data['calls']} calls, {ctx.trace_data['window_s']!r} s "
                     f"tracing the device, {ctx.host_trace['window_s']!r} s with the host's "
                     f"operators; untraced {stats['elapsed_s'] / stats['calls']!r} s a call")
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def _traced_calls(ctx: Context, entry, host: bool) -> dict:
    """`trace_calls` calls under the profiler: tracing the device alone (the
    window's length is the host's clock around the calls), or with the
    host's operators and the benchmark's spans too (`host`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = []
    if host or ctx.device.type != "cuda":
        activities.append(ProfilerActivity.CPU)
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    traced = _stats()
    with profile(activities=activities) as prof:
        with record_function(tracing.WINDOW_SPAN):
            t0 = time.perf_counter()
            for _ in range(int(ctx.traffic["trace_calls"])):
                _add(traced, entry.call())
            entry.drain()
            ctx.sync()
            window_s = time.perf_counter() - t0
    data = tracing.reduce(prof) if host else tracing.reduce_device(prof, window_s)
    data.update(calls=traced["calls"], units=traced["units"], steps=traced["steps"])
    return data
