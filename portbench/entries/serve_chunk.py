"""The multi-stream server's captured path, closed loop:
`AnimationServer.serve_chunk` on K frames of S streams a call, frames
handed in from pinned host memory and brought back into a pinned host
buffer. Every `clip_frames` frames all S streams re-open (`open_streams`)
on new sources, so the re-open and the CUDA graph's capture run inside the
window; the window starts with a re-open and ends at a round's end, so it
holds whole rounds, one re-open each.

Traffic keys: dtype, frame_size, streams, chunk, clip_frames, rounds (the
sources made ahead), motion, warmup_calls, trace_calls, check_steps.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from portbench import frames, inputs
from portbench.harness import COMPUTE_DTYPES
from portbench.weights import make_weights

class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.streams, self.chunk, self.clip_frames = tr["streams"], tr["chunk"], tr["clip_frames"]
        if self.clip_frames % self.chunk:
            raise ValueError("clip_frames must be a multiple of chunk")

    def setup(self) -> None:
        from mrfa_tpu_torch.models.mrfa import MRFA
        from mrfa_tpu_torch.serving import AnimationServer

        ctx, tr = self.ctx, self.ctx.traffic
        size = tr["frame_size"]
        self.clips = inputs.driving_clips(self.streams, self.clip_frames, size, tr["motion"],
                                          ctx.seed, ctx.device)
        self.sources = inputs.sources(tr["rounds"], self.streams, size, tr["motion"],
                                      ctx.seed, ctx.device)
        weights = make_weights(ctx.model_cfg, ctx.seed, ctx.device, ctx.config.get("init"))
        model = MRFA(ctx.model_cfg, device=ctx.device, compute_dtype=COMPUTE_DTYPES[ctx.dtype])
        self.server = AnimationServer(model, weights, device=ctx.device)
        del weights
        self.sample = frames.Sample(tr["check_steps"], ctx.seed)
        self.host = torch.empty((self.chunk,) + tuple(self.sources[0].shape), dtype=torch.float32,
                                pin_memory=ctx.device.type == "cuda")
        self.round, self.t = 0, 0
        self._open()
        for _ in range(tr["warmup_calls"]):
            self.call()

    def _open(self) -> None:
        with record_function("open_streams"):
            self.state = self.server.open_streams(
                self.sources[self.round % len(self.sources)], self.clips[0])

    def call(self) -> dict:
        if self.t == self.clip_frames:
            self.round, self.t = self.round + 1, 0
            self._open()
        t, k = self.t, self.chunk
        t0 = time.perf_counter()
        with record_function("h2d"):
            chunk = self.clips[t:t + k].to(self.ctx.device, non_blocking=False)
        with record_function("serve_chunk"):
            out = self.server.serve_chunk(self.state, chunk)
        with record_function("d2h"):
            host = self.host.copy_(out)
        latency = (time.perf_counter() - t0) * 1e3
        for i in range(k):
            self.sample.offer(self.round, t + i, host[i])
        self.t += k
        units = k * self.streams
        return {"units": units, "steps": k, "latencies_ms": [latency] * units}

    def start_window(self) -> None:
        self.t = self.clip_frames  # the next call opens a new round

    def at_boundary(self) -> bool:
        return self.t == self.clip_frames

    def drain(self) -> None:
        self.ctx.sync()

    def release(self) -> None:
        del self.server, self.state

    def check(self) -> dict:
        model = frames.reference_model(self.ctx)
        self.want = frames.reference_frames(self.ctx, model, self.sample.kept, self.sources,
                                            self.clips, count_flops=self.ctx.trace)
        return frames.compare(self.sample.kept, self.want)
