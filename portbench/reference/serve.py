"""The reference serving frame step: keypoints of the driving frames,
relative-motion normalization against each stream's first frame, dense
motion and the RaftFlow decoder over a per-clip source cache, in f32."""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference.ops.resize import antialias_downsample


def normalize_kp(kp_source: Dict[str, torch.Tensor], kp_driving: Dict[str, torch.Tensor],
                 kp_driving_initial: Dict[str, torch.Tensor], scale=1.0,
                 use_relative_movement: bool = True,
                 use_relative_jacobian: bool = True) -> Dict[str, torch.Tensor]:
    """kp_new = kp_s + (kp_d - kp_d0) * scale; the jacobian
    J_d J_d0^-1 J_s when relative."""
    kp_new = dict(kp_driving)
    if use_relative_movement:
        kp_new["kp"] = (kp_driving["kp"] - kp_driving_initial["kp"]) * scale + kp_source["kp"]
        if use_relative_jacobian and "jacobian" in kp_driving:
            inv_d0 = torch.linalg.inv(kp_driving_initial["jacobian"])
            jacobian_diff = torch.matmul(kp_driving["jacobian"], inv_d0)
            kp_new["jacobian"] = torch.matmul(jacobian_diff, kp_source["jacobian"])
    return kp_new


class Clip:
    """One clip's per-clip state for S streams: (S, 3, H, W) sources and first
    driving frames in [0, 1]."""

    @torch.no_grad()
    def __init__(self, model, sources: torch.Tensor, first_frames: torch.Tensor):
        self.model = model
        self.source = sources
        self.kp_source = model.encode_kp(sources)
        self.kp_d0 = model.encode_kp(first_frames)
        self.img_down = antialias_downsample(sources, 0.25)
        self.cache = model.encode_source_cache(sources, self.kp_source, self.img_down)

    @torch.no_grad()
    def frame(self, driving: torch.Tensor) -> torch.Tensor:
        """(S, 3, H, W) driving frames -> the (S, 3, H, W) generated frames."""
        m = self.model
        kp_driving = m.encode_kp(driving)
        kp_norm = normalize_kp(self.kp_source, kp_driving, self.kp_d0)
        dense_motion = m.run_dense_motion(self.source, kp_norm, self.kp_source)
        out, _, _ = m.decoder(m.kp_for_decoder(self.kp_source), m.kp_for_decoder(kp_norm),
                              dense_motion, self.img_down, self.source,
                              source_cache=self.cache)
        return out
