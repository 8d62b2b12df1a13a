"""One interactive client, closed loop: `Animator.animate_frame` one frame a
call, each frame handed in from pinned host memory and its generated frame
brought back to the host before the next is sent. One session (`begin`
once, in set-up); the clip's frames are sent in order, from its start again
when they run out.

Traffic keys: dtype, frame_size, streams (clients in the session's batch),
clip_frames, motion, warmup_calls, trace_calls, check_steps.
"""
from __future__ import annotations

import time

from torch.profiler import record_function

from portbench import frames, inputs
from portbench.harness import COMPUTE_DTYPES
from portbench.weights import make_weights

class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.streams = ctx.traffic["streams"]
        self.clip_frames = ctx.traffic["clip_frames"]

    def setup(self) -> None:
        from mrfa_tpu_torch.animate import Animator
        from mrfa_tpu_torch.models.mrfa import MRFA

        ctx, tr = self.ctx, self.ctx.traffic
        size = tr["frame_size"]
        self.clips = inputs.driving_clips(self.streams, self.clip_frames, size, tr["motion"],
                                          ctx.seed, ctx.device)
        self.sources = inputs.sources(1, self.streams, size, tr["motion"], ctx.seed, ctx.device)
        weights = make_weights(ctx.model_cfg, ctx.seed, ctx.device, ctx.config.get("init"))
        model = MRFA(ctx.model_cfg, device=ctx.device, compute_dtype=COMPUTE_DTYPES[ctx.dtype])
        self.animator = Animator(model, weights, device=ctx.device)
        del weights
        self.sample = frames.Sample(tr["check_steps"], ctx.seed)
        self.t = 0
        with record_function("open_streams"):
            self.state = self.animator.begin(self.sources[0], self.clips[0])
        for _ in range(tr["warmup_calls"]):
            self.call()

    def call(self) -> dict:
        t = self.t % self.clip_frames
        t0 = time.perf_counter()
        with record_function("h2d"):
            frame = self.clips[t].to(self.ctx.device, non_blocking=False)
        with record_function("animate_frame"):
            out = self.animator.animate_frame(self.state, frame)[0]
        with record_function("d2h"):
            host = out.cpu()
        latency = (time.perf_counter() - t0) * 1e3
        self.sample.offer(0, t, host)
        self.t += 1
        return {"units": self.streams, "steps": 1, "latencies_ms": [latency] * self.streams}

    def drain(self) -> None:
        self.ctx.sync()

    def release(self) -> None:
        del self.animator, self.state

    def check(self) -> dict:
        model = frames.reference_model(self.ctx)
        self.want = frames.reference_frames(self.ctx, model, self.sample.kept, self.sources,
                                            self.clips, count_flops=self.ctx.trace)
        return frames.compare(self.sample.kept, self.want)
