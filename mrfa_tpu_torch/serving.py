"""Batched multi-stream animation serving.

Counterpart of mrfa_tpu/serving.py: many concurrent animation streams (a
source image and a driving video each) advance together, one batched frame
step for all of them. The server is an `Animator` whose clip holds S
streams: `open_streams` is `begin` with a motion scale per stream (each
stream's own convex-hull ratio), `serve` is `animate_frame`'s generated
frames and `serve_chunk` is `animate_chunk`, on CUDA K replays of the
S-stream frame step captured once per stream state as a CUDA graph, which
spreads the host's dispatch cost over the S streams and the K frames.

Over several devices (`devices=`, the JAX server's `mesh=`) the S streams
are split into equal contiguous shares, one a device, each served by its own
replica of the weights; every call hands each device its share before it
gathers any result, and the outputs come back on the first device in the
streams' order.

Frames go in and come out NHWC in [0, 1], f32, as in the JAX package.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mrfa_tpu_torch.animate import Animator, stream_scales
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.utils import profiling

__all__ = ["AnimationServer", "StreamBatchState", "stream_scales"]


class StreamBatchState(NamedTuple):
    """The stacked per-stream state (leading axis: the stream), NCHW, in the
    order of `Animator.begin`'s clip state."""

    source: torch.Tensor  # (S, 3, H, W)
    img_down: torch.Tensor  # (S, 3, H/4, W/4)
    kp_source: Dict[str, torch.Tensor]
    kp_driving_initial: Dict[str, torch.Tensor]
    scale: torch.Tensor  # (S,)
    source_cache: Any  # the decoder's per-clip source work


class AnimationServer(Animator):
    """S animation streams served together over a trained MRFA model, on
    CUDA unless the caller passes another device; built as `Animator` is
    (its weights loaded, and pre-cast once under the bf16 policy).

    `devices` (a list, instead of `device`) splits the streams over those
    devices, one replica of the model on each; S must then be a multiple of
    their number, and the stream state is a tuple of each device's
    `StreamBatchState`."""

    def __init__(self, model: MRFA, weights, device: Optional[Union[str, torch.device]] = None,
                 relative: bool = True, use_relative_jacobian: bool = True,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        if devices is not None and device is not None:
            raise ValueError("pass `device` or `devices`, not both")
        places = [device] if devices is None else list(devices)
        copies = [copy.deepcopy(model) for _ in places[1:]]  # before `model` is loaded
        super().__init__(model, weights, places[0], relative, use_relative_jacobian)
        self.replicas: List[Animator] = [self] + [
            Animator(m, weights, d, relative, use_relative_jacobian)
            for m, d in zip(copies, places[1:])]

    def _split(self, x, dim: int = 0) -> Tuple:
        """The replicas' equal contiguous shares of `x` along `dim`."""
        n, size = len(self.replicas), x.shape[dim]
        if size % n:
            raise ValueError(f"{size} streams do not split over {n} devices")
        lead = (slice(None),) * dim
        return tuple(x[lead + (slice(i * size // n, (i + 1) * size // n),)] for i in range(n))

    @torch.inference_mode()
    def open_streams(self, sources, first_frames, adapt_movement_scale: bool = False):
        """The state of S streams from their (S, H, W, 3) sources and first
        driving frames; with `adapt_movement_scale` each stream's motion is
        scaled by its own convex-hull ratio (`stream_scales`)."""
        with profiling.span("server.open_streams"):
            if len(self.replicas) == 1:
                return _stream_state(self, self.begin(sources, first_frames),
                                     adapt_movement_scale)
            begun = [r.begin(s, f) for r, s, f in
                     zip(self.replicas, self._split(sources), self._split(first_frames))]
            return tuple(_stream_state(r, b, adapt_movement_scale)
                         for r, b in zip(self.replicas, begun))

    def serve(self, state, frames) -> torch.Tensor:
        """Advance every stream one frame: (S, H, W, 3) -> (S, H, W, 3)."""
        if len(self.replicas) == 1:
            return self.animate_frame(state, frames)[0]
        outs = [r.animate_frame(st, f)[0]
                for r, st, f in zip(self.replicas, state, self._split(frames))]
        return torch.cat([o.to(self.device) for o in outs])

    def serve_chunk(self, state, frames) -> torch.Tensor:
        """Advance every stream K frames: (K, S, H, W, 3) -> (K, S, H, W, 3),
        each frame as `serve` makes it."""
        if len(self.replicas) == 1:
            return self.animate_chunk(state, frames)
        outs = [r.animate_chunk(st, f)
                for r, st, f in zip(self.replicas, state, self._split(frames, dim=1))]
        return torch.cat([o.to(self.device) for o in outs], dim=1)


def _stream_state(replica: Animator, begun, adapt_movement_scale: bool) -> StreamBatchState:
    """`Animator.begin`'s clip state as a `StreamBatchState`, with each
    stream's own scale when `adapt_movement_scale`."""
    source, img_down, kp_source, kp_d0, _, cache = begun
    scale = (torch.from_numpy(stream_scales(kp_source, kp_d0)).float()
             if adapt_movement_scale else torch.ones(source.shape[0]))
    return StreamBatchState(source, img_down, kp_source, kp_d0, scale.to(replica.device), cache)
