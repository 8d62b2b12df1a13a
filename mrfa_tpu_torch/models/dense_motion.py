"""Dense motion networks: sparse keypoint motions -> dense flow + occlusion.

Counterpart of mrfa_tpu/models/dense_motion.py:
  - `DenseMotionNetwork` (the FOMM and MTIA priors): per-keypoint
    translation (+ jacobian) sparse motions, heatmap differences, the source
    warped by each motion (align_corners=False, zero padding), an
    hourglass, a channel softmax -> convex combination deformation, and
    occlusion logits;
  - `TPSDenseMotionNetwork` (the TPSM prior): K exact TPS transforms from
    K x 5 keypoint pairs beside the (optionally affine) background motion,
    the source warped by each (align_corners=True, zero padding), an
    hourglass over the heatmaps block and then the per-motion RGB block,
    and the contribution maps and occlusion logits.
With `dropout_flag` either network replaces its channel softmax by the TPSM
channel dropout-softmax (`_dropout_softmax`) over a (B, K+1) keep mask: the
caller's (`Trainer` draws it from its own generator, `dropout_keep`), or one
drawn from torch's default generator.

Each network opens the frame step's stage `frame.dense_motion`; the TPS
network opens `frame.tps` first, around its heatmaps, fits, grids and warps.

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
from mrfa_tpu_torch.ops.tps import tps_fit, tps_transform_grid
from mrfa_tpu_torch.utils import profiling
from mrfa_tpu_torch.utils.device import to_device


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """torch.einsum over operands cast to their promoted dtype (as jnp.einsum)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in operands))
    return torch.einsum(equation, *(t.to(dtype) for t in operands))


def dropout_keep(b: int, c: int, p, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The (B, C) keep mask of the channel dropout: each channel kept with
    probability 1 - p, channel 0 (the background) always; drawn on the
    generator's device (the default generator's when None) and moved to
    `device`."""
    gen_dev = generator.device if generator is not None else torch.device("cpu")
    keep = torch.rand(b, c, generator=generator, device=gen_dev) < (1.0 - float(p))
    keep[:, 0] = True
    return to_device(keep, device)


def _dropout_softmax(logits: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Channel dropout-softmax (Eq. 7-8 of TPSM) over the (B, C, h, w)
    logits with a (B, C) keep mask. The reference's inverted-dropout rescale
    acts on a tensor it then drops, so no rescale happens here either."""
    x = logits - logits.amax(dim=1, keepdim=True)
    x_exp = torch.exp(x) * keep[:, :, None, None].to(logits.dtype)
    return x_exp / (x_exp.sum(dim=1, keepdim=True) + 1e-6)


def _motion_softmax(logits, dropout_flag, dropout_p, keep):
    if not dropout_flag:
        return torch.softmax(logits, dim=1)
    if keep is None:
        keep = dropout_keep(logits.shape[0], logits.shape[1], dropout_p, None, logits.device)
    if keep.shape != logits.shape[:2]:
        raise ValueError(f"a keep mask of {tuple(keep.shape)} for {tuple(logits.shape[:2])} "
                         "motion logits")
    return _dropout_softmax(logits, keep)


class DenseMotionNetwork(nn.Module):
    def __init__(self, block_expansion=64, num_blocks=5, max_features=1024, num_kp=10,
                 num_channels=3, estimate_occlusion_map=True, scale_factor=0.25,
                 kp_variance=0.01, compute_dtype=None):
        super().__init__()
        k1 = self.motions = num_kp + 1  # the softmax's channels
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
        dropout_flag: bool = False,
        dropout_p=0.0,
        keep: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        with profiling.stage("frame.dense_motion"):  # the frame step's stage
            source_image = antialias_downsample(source_image, self.scale_factor)
            bs, c, h, w = source_image.shape
            heatmap = self.create_heatmap_representations(h, w, kp_driving, kp_source)
            sparse_motion = self.create_sparse_motions(h, w, kp_driving, kp_source, bg_param)
            deformed = self.create_deformed_source_image(source_image, sparse_motion)
            # (heatmap, rgb) interleaved per motion: the reference's channel order
            inp = torch.cat([heatmap[:, :, None], deformed], dim=2).reshape(bs, -1, h, w)
            prediction = self.hourglass(inp)
            mask = _motion_softmax(self.mask(prediction), dropout_flag, dropout_p, keep)
            out = {
                "sparse_deformed": deformed,
                "mask": mask,
                "deformation": einsum("bkhwc,bkhw->bhwc", sparse_motion, mask),
            }
            if self.occlusion is not None:
                out["occlusion"] = self.occlusion(prediction)
            return out


class TPSDenseMotionNetwork(nn.Module):
    def __init__(self, block_expansion=64, num_blocks=5, max_features=1024, num_tps=10,
                 num_channels=3, scale_factor=0.25, bg=False, multi_mask=False,
                 kp_variance=0.01):
        super().__init__()
        if multi_mask:
            raise NotImplementedError(
                "multi_mask is dead code in the reference configs (its path in the "
                "reference's dense_motion.py has unbound imports); the single "
                "occlusion map is supported"
            )
        self.scale_factor = scale_factor
        self.kp_variance = kp_variance
        self.motions = num_tps + 1  # the softmax's channels
        in_features = num_channels * (num_tps + 1) + num_tps * 5 + 1
        self.hourglass = Hourglass(block_expansion, in_features=in_features,
                                   max_features=max_features, num_blocks=num_blocks)
        self.maps = conv2d(self.hourglass.out_filters, num_tps + 1, 7, padding=3)
        self.occlusion = nn.ModuleList([conv2d(self.hourglass.out_filters, 1, 7, padding=3)])

    def create_heatmap_representations(self, h, w, kp_driving, kp_source):
        heatmap = kp2gaussian(kp_driving["kp"], (h, w), self.kp_variance) - kp2gaussian(
            kp_source["kp"], (h, w), self.kp_variance
        )  # (B, K*5, h, w)
        return torch.cat([torch.zeros_like(heatmap[:, :1]), heatmap], dim=1)

    def create_transformations(self, h, w, kp_driving, kp_source, bg_param=None):
        """The background motion and the K fitted TPS warps: (B, K+1, h, w, 2)."""
        bs = kp_driving["kp"].shape[0]
        kp_1 = kp_driving["kp"].reshape(bs, -1, 5, 2)
        kp_2 = kp_source["kp"].reshape(bs, -1, 5, 2)
        driving_to_source = tps_transform_grid(tps_fit(kp_1, kp_2), h, w)
        grid = make_coordinate_grid(h, w, dtype=kp_1.dtype, device=kp_1.device)
        identity = grid[None, None].expand(bs, 1, h, w, 2)
        if bg_param is not None:
            identity = from_homogeneous(
                einsum("bij,bkhwj->bkhwi", bg_param, to_homogeneous(identity)))
        return torch.cat([identity, driving_to_source], dim=1)

    def create_deformed_source_image(self, source_image, transformations):
        """The source warped by each of the K+1 motions: (B, K+1, C, h, w)."""
        bs, c, h, w = source_image.shape
        k1 = transformations.shape[1]
        # align_corners=True here, unlike DenseMotionNetwork (the reference's)
        warped = grid_sample(source_image, transformations.reshape(bs, k1 * h, w, 2),
                             align_corners=True)
        return warped.reshape(bs, c, k1, h, w).transpose(1, 2)

    def forward(
        self,
        source_image: torch.Tensor,
        kp_driving: Dict[str, torch.Tensor],
        kp_source: Dict[str, torch.Tensor],
        bg_param: Optional[torch.Tensor] = None,
        dropout_flag: bool = False,
        dropout_p=0.0,
        keep: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        # the frame step's stage frame.tps: the heatmaps, the K fits, their
        # dense grids and the K+1 warps of the source
        with profiling.stage("frame.tps"):
            if self.scale_factor != 1:
                source_image = antialias_downsample(source_image, self.scale_factor)
            bs, c, h, w = source_image.shape
            heatmap = self.create_heatmap_representations(h, w, kp_driving, kp_source)
            transformations = self.create_transformations(h, w, kp_driving, kp_source, bg_param)
            deformed = self.create_deformed_source_image(source_image, transformations)
        with profiling.stage("frame.dense_motion"):
            # the heatmaps block first, then the per-motion RGB block
            inp = torch.cat([heatmap, deformed.reshape(bs, -1, h, w)], dim=1)
            prediction = self.hourglass(inp)
            contribution = _motion_softmax(self.maps(prediction), dropout_flag, dropout_p, keep)
            return {
                "deformed_source": deformed,
                "contribution_maps": contribution,
                "mask": contribution,
                "deformation": einsum("bkhwc,bkhw->bhwc", transformations, contribution),
                "occlusion": self.occlusion[0](prediction),
            }
