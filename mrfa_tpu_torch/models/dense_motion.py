"""Dense motion network: sparse keypoint motions -> dense flow + occlusion.

Counterpart of mrfa_tpu/models/dense_motion.py::DenseMotionNetwork (the
FOMM/MTIA priors): per-keypoint translation (+ jacobian) sparse motions,
heatmap differences, the source warped by each motion (align_corners=False,
zero padding), an hourglass, a channel softmax -> convex combination
deformation, and occlusion logits.

Layouts: the returned `deformation` is a (B, h, w, 2) normalized grid, as
`F.grid_sample` takes it; `occlusion` logits are (B, 1, h, w).

Under the bf16 policy (`compute_dtype`, see precision.py) the source pixels
are warped in bf16; products of mixed dtypes promote, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from mrfa_tpu_torch.nn.blocks import Hourglass, conv2d
from mrfa_tpu_torch.ops.grid import (
    from_homogeneous,
    kp2gaussian,
    make_coordinate_grid,
    to_homogeneous,
)
from mrfa_tpu_torch.ops.resize import antialias_downsample
from mrfa_tpu_torch.ops.sampler import grid_sample


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """torch.einsum over operands cast to their promoted dtype (as jnp.einsum)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in operands))
    return torch.einsum(equation, *(t.to(dtype) for t in operands))


class DenseMotionNetwork(nn.Module):
    def __init__(self, block_expansion=64, num_blocks=5, max_features=1024, num_kp=10,
                 num_channels=3, estimate_occlusion_map=True, scale_factor=0.25,
                 kp_variance=0.01, compute_dtype=None):
        super().__init__()
        k1 = num_kp + 1
        self.compute_dtype = compute_dtype
        self.scale_factor = scale_factor
        self.kp_variance = kp_variance
        self.hourglass = Hourglass(
            block_expansion, in_features=k1 * (num_channels + 1),
            max_features=max_features, num_blocks=num_blocks,
        )
        self.mask = conv2d(self.hourglass.out_filters, k1, 7, padding=3)
        self.occlusion = (
            conv2d(self.hourglass.out_filters, 1, 7, padding=3)
            if estimate_occlusion_map else None
        )

    def create_heatmap_representations(self, h, w, kp_driving, kp_source):
        heatmap = kp2gaussian(kp_driving["kp"], (h, w), self.kp_variance) - kp2gaussian(
            kp_source["kp"], (h, w), self.kp_variance
        )  # (B, K, h, w)
        return torch.cat([torch.zeros_like(heatmap[:, :1]), heatmap], dim=1)

    def create_sparse_motions(self, h, w, kp_driving, kp_source, bg_param=None):
        """Per-motion backward grids T_{s<-d}: (B, K+1, h, w, 2), normalized."""
        kp_d, kp_s = kp_driving["kp"], kp_source["kp"]
        bs = kp_d.shape[0]
        grid = make_coordinate_grid(h, w, dtype=kp_d.dtype, device=kp_d.device)
        coordinate_grid = grid[None, None] - kp_d[:, :, None, None, :]  # (B,K,h,w,2)
        if "jacobian" in kp_driving:
            # inv_ex: no host sync for the singularity check
            inv_d = torch.linalg.inv_ex(kp_driving["jacobian"]).inverse
            jac = torch.matmul(kp_source["jacobian"], inv_d)
            coordinate_grid = einsum("bkij,bkhwj->bkhwi", jac, coordinate_grid)
        driving_to_source = coordinate_grid + kp_s[:, :, None, None, :]
        bg_grid = grid[None, None].expand(bs, 1, h, w, 2)
        if bg_param is not None:
            bgh = einsum("bij,bkhwj->bkhwi", bg_param, to_homogeneous(bg_grid))
            bg_grid = from_homogeneous(bgh)
        return torch.cat([bg_grid, driving_to_source], dim=1)

    def create_deformed_source_image(self, source_image, sparse_motions):
        """The source warped by each of the K+1 motions: (B, K+1, C, h, w)."""
        bs, c, h, w = source_image.shape
        k1 = sparse_motions.shape[1]
        if self.compute_dtype is not None:
            source_image = source_image.to(self.compute_dtype)
        # the K+1 motions ride on the sample axis of one warp of the source
        warped = grid_sample(source_image, sparse_motions.reshape(bs, k1 * h, w, 2),
                             align_corners=False)
        return warped.reshape(bs, c, k1, h, w).transpose(1, 2)

    def forward(
        self,
        source_image: torch.Tensor,
        kp_driving: Dict[str, torch.Tensor],
        kp_source: Dict[str, torch.Tensor],
        bg_param: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        source_image = antialias_downsample(source_image, self.scale_factor)
        bs, c, h, w = source_image.shape
        heatmap = self.create_heatmap_representations(h, w, kp_driving, kp_source)
        sparse_motion = self.create_sparse_motions(h, w, kp_driving, kp_source, bg_param)
        deformed = self.create_deformed_source_image(source_image, sparse_motion)
        # (heatmap, rgb) interleaved per motion: the reference's channel order
        inp = torch.cat([heatmap[:, :, None], deformed], dim=2).reshape(bs, -1, h, w)
        prediction = self.hourglass(inp)
        mask = torch.softmax(self.mask(prediction), dim=1)  # (B, K+1, h, w)
        out = {
            "sparse_deformed": deformed,
            "mask": mask,
            "deformation": einsum("bkhwc,bkhw->bhwc", sparse_motion, mask),
        }
        if self.occlusion is not None:
            out["occlusion"] = self.occlusion(prediction)
        return out
