"""Batched multi-stream animation serving.

Counterpart of mrfa_tpu/serving.py: many concurrent animation streams (a
source image and a driving video each) advance together, one batched frame
step for all of them. The server is an `Animator` whose clip holds S
streams: `open_streams` is `begin` with a motion scale per stream (each
stream's own convex-hull ratio), `serve` is `animate_frame`'s generated
frames and `serve_chunk` is `animate_chunk`, on CUDA K replays of the
S-stream frame step captured once per stream state as a CUDA graph, which
spreads the host's dispatch cost over the S streams and the K frames.

Frames go in and come out NHWC in [0, 1], f32, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from mrfa_tpu_torch.animate import Animator, stream_scales

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
    (its weights loaded, and pre-cast once under the bf16 policy)."""

    @torch.inference_mode()
    def open_streams(self, sources, first_frames,
                     adapt_movement_scale: bool = False) -> StreamBatchState:
        """The state of S streams from their (S, H, W, 3) sources and first
        driving frames; with `adapt_movement_scale` each stream's motion is
        scaled by its own convex-hull ratio (`stream_scales`)."""
        source, img_down, kp_source, kp_d0, _, cache = self.begin(sources, first_frames)
        scale = (torch.from_numpy(stream_scales(kp_source, kp_d0)).float()
                 if adapt_movement_scale else torch.ones(source.shape[0]))
        return StreamBatchState(source, img_down, kp_source, kp_d0, scale.to(self.device), cache)

    def serve(self, state: StreamBatchState, frames) -> torch.Tensor:
        """Advance every stream one frame: (S, H, W, 3) -> (S, H, W, 3)."""
        return self.animate_frame(state, frames)[0]

    def serve_chunk(self, state: StreamBatchState, frames) -> torch.Tensor:
        """Advance every stream K frames: (K, S, H, W, 3) -> (K, S, H, W, 3),
        each frame as `serve` makes it."""
        return self.animate_chunk(state, frames)
