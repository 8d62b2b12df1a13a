"""Tracing, step timing and numerical debugging.

Counterpart of mrfa_tpu/utils/profiling.py:
  - `trace(logdir)`: a torch.profiler trace of the enclosed region (host and,
    where there is one, the card), written into `logdir` as a Chrome trace
    (open it in Perfetto or chrome://tracing);
  - `annotate(name)`: a named span in that trace;
  - `debug_nans(enable)`: autograd's anomaly mode;
  - `StepTimer`: step time and throughput with warm-up steps skipped,
    synchronizing the card around each step so a step's time is the
    device's and not the time to queue it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional, Union

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed region into
    `logdir`/trace.json (CPU activity always, CUDA when the card is there)."""
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


def annotate(name: str):
    """A named span in the profiler's timeline (`record_function`)."""
    return torch.profiler.record_function(name)


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on or off. Unlike `jax_debug_nans`, which
    raises at the first primitive of any computation that makes a NaN, it
    checks the backward: a backward function that returns a NaN raises, with
    the forward operation that made it in the traceback. A NaN made in a
    forward run without autograd is not caught."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Step time and throughput; skips the first `warmup` steps (kernel
    builds, cuDNN planning). With a CUDA `device` it synchronizes the card on
    entry and exit, so each step is timed to the end of its device work."""

    def __init__(self, warmup: int = 1, device: Optional[Union[str, torch.device]] = None):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._sync = device is not None and torch.device(device).type == "cuda"
        self._t0: Optional[float] = None

    def __enter__(self):
        if self._sync:
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        return False

    @property
    def steps_timed(self) -> int:
        return max(0, self.count - self.warmup)

    @property
    def mean_step_time(self) -> float:
        return self.total / self.steps_timed if self.steps_timed else float("nan")

    def throughput(self, items_per_step: int) -> float:
        t = self.mean_step_time
        return items_per_step / t if t == t and t > 0 else float("nan")
