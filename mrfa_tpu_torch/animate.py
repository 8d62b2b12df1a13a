"""Animation API: relative-motion keypoint normalization and the frame loop.

Counterpart of mrfa_tpu/animate.py. Per clip, `Animator.begin` encodes the
source keypoints, the first driving frame's keypoints, the 0.25x source and
the decoder's source cache once; per frame, `animate_frame` encodes the
driving keypoints, normalizes them relative to the first frame, runs dense
motion and the RaftFlow decoder. Images go in and come out NHWC in [0, 1],
as in the JAX package; inside, the model runs NCHW.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.ops.resize import antialias_downsample
from mrfa_tpu_torch.utils.convert import load_jax_variables
from mrfa_tpu_torch.utils.device import resolve_device

# JAX-model subtrees the port does not build
JAX_ONLY_MODULES = ("bg_predictor",)


def movement_scale(kp_source, kp_driving_initial) -> float:
    """sqrt of the ratio of the convex-hull areas of the source and the initial
    driving keypoints (first sample)."""
    from scipy.spatial import ConvexHull

    def area(kp):
        return ConvexHull(kp["kp"][0].detach().cpu().numpy()).volume

    return float(np.sqrt(area(kp_source)) / np.sqrt(area(kp_driving_initial)))


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
    source and initial driving keypoints) or a precomputed float scale.
    """
    if isinstance(adapt_movement_scale, bool):
        scale = movement_scale(kp_source, kp_driving_initial) if adapt_movement_scale else 1.0
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
    return x.permute(0, 2, 3, 1)


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
            load_jax_variables(model, weights, skip=JAX_ONLY_MODULES)
        else:
            model.load_state_dict(weights)
        self.model = model.to(self.device).eval()
        self.relative = relative
        self.use_relative_jacobian = use_relative_jacobian

    def _image(self, image) -> torch.Tensor:
        """(H, W, 3) or (B, H, W, 3) in [0, 1] -> (B, 3, H, W) f32 on the device."""
        x = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
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
        source, img_down, kp_source, kp_d0, scale, cache = clip_state
        model = self.model
        kp_driving = model.encode_kp(self._image(driving_frame))
        kp_norm = normalize_kp(
            kp_source, kp_driving, kp_d0,
            adapt_movement_scale=scale,
            use_relative_movement=self.relative,
            use_relative_jacobian=self.relative and self.use_relative_jacobian,
        )
        dense_motion = model.run_dense_motion(source, kp_norm, kp_source)
        out, warp_img, occlusion = model.decoder(
            model.kp_for_decoder(kp_source), model.kp_for_decoder(kp_norm),
            dense_motion, img_down, source, source_cache=cache,
        )
        return _nhwc(out), _nhwc(warp_img), _nhwc(occlusion)

    def make_animation(
        self, source_image, driving_video, adapt_movement_scale: bool = False
    ) -> List[np.ndarray]:
        """Animate a (T, H, W, 3) driving clip frame by frame -> T (H, W, 3) arrays."""
        clip_state = self.begin(source_image, driving_video[0], adapt_movement_scale)
        return [
            self.animate_frame(clip_state, frame)[0][0].cpu().numpy()
            for frame in driving_video
        ]

    def find_best_frame(self, source_image, driving_video) -> int:
        """Index of the driving frame whose keypoints are closest to the source's."""
        kp_source = self.encode_kp(source_image)["kp"][0]
        dists = [
            float(((self.encode_kp(frame)["kp"][0] - kp_source) ** 2).sum())
            for frame in driving_video
        ]
        return int(np.argmin(dists))
