"""Animation API: relative-motion keypoint normalization and the frame loop.

Counterpart of mrfa_tpu/animate.py. Per clip, `Animator.begin` encodes the
source keypoints, the first driving frame's keypoints, the 0.25x source and
the decoder's source cache once; per frame, `animate_frame` encodes the
driving keypoints, normalizes them relative to the first frame, runs dense
motion and the RaftFlow decoder; `animate_chunk` does K frames in one call,
on CUDA as K replays of the frame step captured once per clip as a CUDA
graph (the eager frame is bound by the host's ~2300 dispatches). Images go in and come out NHWC in [0, 1], f32, as in the JAX package; inside,
the model runs NCHW, in bf16 where the model's `compute_dtype` says so
(precision.py), and then the Animator pre-casts the weights once.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.ops.resize import antialias_downsample
from mrfa_tpu_torch.precision import cast_params_for_inference
from mrfa_tpu_torch.utils import profiling
from mrfa_tpu_torch.utils.convert import load_jax_variables
from mrfa_tpu_torch.utils.device import resolve_device

def stream_scales(kp_source, kp_driving_initial) -> np.ndarray:
    """(B,) sqrt of the ratio of the convex-hull areas of each sample's own
    source and initial driving keypoints."""
    from scipy.spatial import ConvexHull

    kps, kpd = (kp["kp"].detach().float().cpu().numpy()
                for kp in (kp_source, kp_driving_initial))
    return np.array([np.sqrt(ConvexHull(s).volume) / np.sqrt(ConvexHull(d).volume)
                     for s, d in zip(kps, kpd)])


def movement_scale(kp_source, kp_driving_initial) -> float:
    """The first sample's `stream_scales`."""
    return float(stream_scales({"kp": kp_source["kp"][:1]},
                               {"kp": kp_driving_initial["kp"][:1]})[0])


def normalize_kp(
    kp_source: Dict[str, torch.Tensor],
    kp_driving: Dict[str, torch.Tensor],
    kp_driving_initial: Dict[str, torch.Tensor],
    adapt_movement_scale=False,
    use_relative_movement: bool = False,
    use_relative_jacobian: bool = False,
) -> Dict[str, torch.Tensor]:
    """Relative-motion transfer: kp_new = kp_s + (kp_d - kp_d0) * scale.

    `adapt_movement_scale` is a bool (True: convex-hull area ratio of the
    source and initial driving keypoints, first sample), a precomputed float
    scale or a (B,) tensor of them, one a sample.
    """
    if isinstance(adapt_movement_scale, bool):
        scale = movement_scale(kp_source, kp_driving_initial) if adapt_movement_scale else 1.0
    elif torch.is_tensor(adapt_movement_scale):
        scale = adapt_movement_scale.reshape(-1, 1, 1)
    else:
        scale = adapt_movement_scale

    kp_new = dict(kp_driving)
    if use_relative_movement:
        kp_new["kp"] = (kp_driving["kp"] - kp_driving_initial["kp"]) * scale + kp_source["kp"]
        if use_relative_jacobian and "jacobian" in kp_driving:
            inv_d0 = torch.linalg.inv_ex(kp_driving_initial["jacobian"]).inverse
            jacobian_diff = torch.matmul(kp_driving["jacobian"], inv_d0)
            kp_new["jacobian"] = torch.matmul(jacobian_diff, kp_source["jacobian"])
    return kp_new


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).float()


class FrameGraph:
    """One clip's frame step captured as a CUDA graph. `replay(frame)` copies
    the (B, H, W, 3) frame into the captured input, replays the step and
    returns the generated (B, H, W, 3) image (a view of the graph's output,
    overwritten by the next replay). The counts the capture bumped (the
    kernels' launches among them) grow by as much at every replay. The
    step's stage boundaries record the graph's `stages` timing events at
    every replay. The graph is captured and replayed on the frame's device,
    whichever device is current."""

    WARMUP_STEPS = 2  # eager steps before the capture

    def __init__(self, step, clip_state, frame: torch.Tensor):
        self.clip_state = clip_state
        self.input = frame.clone()
        self.stages = profiling.StageEvents()
        with profiling.span("graph.capture"), torch.cuda.device(self.input.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # cuDNN and cuBLAS pick their kernels here
                for _ in range(self.WARMUP_STEPS):
                    with self.stages.timing():
                        step(clip_state, self.input)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # not torch.cuda.graph's default capture stream: one for the whole
            # process, made on the device that was current at its first capture
            with profiling.CapturedCounts() as self.counts:
                with torch.cuda.graph(self.graph, stream=side), self.stages.timing():
                    self.output = step(clip_state, self.input)[0]
        self.capture = profiling.count("graph.captures")  # this capture's id
        self.launches = {k[len(profiling.LAUNCH):]: n for k, n in self.counts.delta.items()
                         if k.startswith(profiling.LAUNCH)}

    def replay(self, frame: torch.Tensor) -> torch.Tensor:
        with torch.cuda.device(self.input.device):
            self.input.copy_(frame)
            self.graph.replay()
        self.counts.replay()
        profiling.count("graph.replays")
        return self.output


class Animator:
    """Per-frame animation over a trained MRFA model, on CUDA unless the
    caller passes another device.

    `weights` is either a port `state_dict()` or the JAX package's variables
    {'params', 'batch_stats'} (carried over by `load_jax_variables`).
    """

    def __init__(
        self,
        model: MRFA,
        weights: Mapping[str, Any],
        device: Optional[Union[str, torch.device]] = None,
        relative: bool = True,
        use_relative_jacobian: bool = True,
    ):
        self.device = resolve_device(device)
        if "params" in weights:
            load_jax_variables(model, weights)
        else:
            model.load_state_dict(weights)
        self.model = model.to(self.device).eval()
        if model.compute_dtype is not None:
            cast_params_for_inference(model, model.compute_dtype)
        self.relative = relative
        self.use_relative_jacobian = use_relative_jacobian
        self._graph: Optional[FrameGraph] = None  # the last clip's, for animate_chunk

    def _image(self, image) -> torch.Tensor:
        """(H, W, 3) or (B, H, W, 3) in [0, 1] -> (B, 3, H, W) f32 on the device."""
        x = torch.as_tensor(np.ascontiguousarray(image) if not torch.is_tensor(image) else image)
        x = x.to(device=self.device, dtype=torch.float32)
        if x.dim() == 3:
            x = x[None]
        return x.permute(0, 3, 1, 2).contiguous()

    @torch.inference_mode()
    def encode_kp(self, image) -> Dict[str, torch.Tensor]:
        return self.model.encode_kp(self._image(image))

    @torch.inference_mode()
    def begin(self, source_image, first_driving_frame, adapt_movement_scale: bool = False):
        """Per-clip setup: source and initial driving keypoints, scale, cache."""
        with profiling.span("animator.begin"):
            source = self._image(source_image)
            kp_source = self.model.encode_kp(source)
            kp_d0 = self.model.encode_kp(self._image(first_driving_frame))
            scale = movement_scale(kp_source, kp_d0) if adapt_movement_scale else 1.0
            img_down = antialias_downsample(source, 0.25)
            cache = self.model.encode_source_cache(source, kp_source, img_down)
            return source, img_down, kp_source, kp_d0, scale, cache

    @torch.inference_mode()
    def animate_frame(self, clip_state, driving_frame):
        """One frame step -> (generated, warped source, occlusion strip), NHWC."""
        return self._frame_step(clip_state, driving_frame)

    def _frame_step(self, clip_state, driving_frame):
        source, img_down, kp_source, kp_d0, scale, cache = clip_state
        model = self.model
        with profiling.stage("frame.keypoints"):
            kp_driving = model.encode_kp(self._image(driving_frame))
            kp_norm = normalize_kp(
                kp_source, kp_driving, kp_d0,
                adapt_movement_scale=scale,
                use_relative_movement=self.relative,
                use_relative_jacobian=self.relative and self.use_relative_jacobian,
            )
        with profiling.stage("frame.dense_motion"):
            dense_motion = model.run_dense_motion(source, kp_norm, kp_source)
        # the decoder opens the stages frame.levels, frame.refine and frame.decode
        out, warp_img, occlusion = model.decoder(
            model.kp_for_decoder(kp_source), model.kp_for_decoder(kp_norm),
            dense_motion, img_down, source, source_cache=cache,
        )
        return _nhwc(out), _nhwc(warp_img), _nhwc(occlusion)

    @torch.inference_mode()
    def animate_chunk(self, clip_state, driving_frames) -> torch.Tensor:
        """K frames in one call: (K, H, W, 3) or (K, B, H, W, 3) -> the
        generated (K, B, H, W, 3), each frame as `animate_frame` makes it.
        On CUDA the call's device time, the device's idle time before it and,
        on a sampled call, its last replay's stage times go to the telemetry
        registry (`utils.profiling`), read there later without waiting."""
        with profiling.span("animator.chunk"):
            frames = self._frames(driving_frames)
            if self.device.type != "cuda":
                return torch.stack([self._frame_step(clip_state, f)[0] for f in frames])
            graph = self._graph
            captured = (graph is None or graph.clip_state is not clip_state
                        or graph.input.shape != frames.shape[1:])
            if captured:
                # Free the last clip's graph, and so its memory pool, before the
                # capture: torch.cuda.graph empties the cache as it starts, and
                # under capture nothing more is given back. A convolution whose
                # cuDNN plan cannot get its workspace there is given another
                # plan (an f32 FFT plan's workspace takes many GB), and the
                # graph then departs from the eager step.
                graph = self._graph = None
                graph = self._graph = FrameGraph(self._frame_step, clip_state, frames[0])
            out = torch.empty_like(frames)
            with torch.cuda.device(graph.input.device), profiling.REGISTRY.call(
                    graph.input.device, graph.capture, captured, graph.stages):
                for k, f in enumerate(frames):
                    out[k] = graph.replay(f)
            return out

    def _frames(self, frames) -> torch.Tensor:
        """(K, H, W, 3) or (K, B, H, W, 3) -> (K, B, H, W, 3) on the device."""
        x = torch.as_tensor(np.ascontiguousarray(frames) if not torch.is_tensor(frames) else frames)
        x = x.to(device=self.device, dtype=torch.float32)
        return x[:, None] if x.dim() == 4 else x

    def make_animation(
        self, source_image, driving_video, adapt_movement_scale: bool = False, chunk: int = 1
    ) -> List[np.ndarray]:
        """Animate a (T, H, W, 3) driving clip -> T (H, W, 3) arrays, `chunk`
        frames a call (the tail that fills no chunk frame by frame)."""
        clip_state = self.begin(source_image, driving_video[0], adapt_movement_scale)
        out: List[np.ndarray] = []
        t, n = 0, len(driving_video)
        while t < n:
            if chunk > 1 and n - t >= chunk:
                gen = self.animate_chunk(clip_state, driving_video[t:t + chunk])
                out.extend(gen[:, 0].cpu().numpy())
                t += chunk
            else:
                out.append(self.animate_frame(clip_state, driving_video[t])[0][0].cpu().numpy())
                t += 1
        return out

    def find_best_frame(self, source_image, driving_video) -> int:
        """Index of the driving frame whose keypoints are closest to the source's."""
        kp_source = self.encode_kp(source_image)["kp"][0]
        dists = [
            float(((self.encode_kp(frame)["kp"][0] - kp_source) ** 2).sum())
            for frame in driving_video
        ]
        return int(np.argmin(dists))

    def make_animation_from_best_frame(
        self, source_image, driving_video, adapt_movement_scale: bool = False
    ) -> List[np.ndarray]:
        """Animate forward and backward from the driving frame that best matches
        the source, so that relative motion starts from the closest pose."""
        i = self.find_best_frame(source_image, driving_video)
        forward = self.make_animation(source_image, driving_video[i:], adapt_movement_scale)
        backward = self.make_animation(source_image, driving_video[: i + 1][::-1],
                                       adapt_movement_scale)
        return backward[::-1] + forward[1:]
