"""Keypoint detectors of the FOMM and TPSM priors, NCHW.

Counterpart of mrfa_tpu/models/kp_detector.py (the reference's
modules/kp_detector.py):
  - `KPDetector` (FOMM): a 0.25x anti-aliased downsample, the `predictor`
    hourglass, a 7x7 valid convolution to K heatmaps, a temperature softmax
    over space and a soft-argmax against the [-1, 1] grid; optionally the
    `jacobian` head (initialized to the identity) and the per-keypoint
    visibility head `kp_occlusion.0-4`;
  - `TPSKPDetector` (TPSM): a ResNet-18 regressing num_tps * 5 keypoints,
    squashed into [-1, 1].
Keypoints come out as in the MTIA encoder: "kp" (B, K, 2) xy, "jacobian"
(B, K, 2, 2).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from portbench.reference.nn.blocks import DownBlock2d, Hourglass, conv2d
from portbench.reference.nn.resnet import ResNet18
from portbench.reference.ops.grid import make_coordinate_grid
from portbench.reference.ops.resize import antialias_downsample


def gaussian2kp(heatmap: torch.Tensor) -> torch.Tensor:
    """Soft-argmax: (B, K, h, w) normalized heatmaps -> (B, K, 2) in [-1, 1]."""
    _, _, h, w = heatmap.shape
    grid = make_coordinate_grid(h, w, dtype=heatmap.dtype, device=heatmap.device)
    return torch.einsum("bkhw,hwc->bkc", heatmap, grid)


class KPDetector(nn.Module):
    """The FOMM prior's keypoint detector."""

    def __init__(self, block_expansion=32, num_kp=10, num_channels=3, max_features=1024,
                 num_blocks=5, temperature=0.1, scale_factor=0.25, estimate_jacobian=False,
                 estimate_occlusion=False):
        super().__init__()
        self.temperature = temperature
        self.scale_factor = scale_factor
        self.predictor = Hourglass(block_expansion, in_features=num_channels,
                                   max_features=max_features, num_blocks=num_blocks)
        cout = self.predictor.out_filters
        self.kp = conv2d(cout, num_kp, 7)
        self.jacobian = None
        if estimate_jacobian:
            # a 4-channel head that starts at the identity jacobian
            self.jacobian = conv2d(cout, 4, 7)
            with torch.no_grad():
                self.jacobian.weight.zero_()
                self.jacobian.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 1.0]))
        self.kp_occlusion = None
        if estimate_occlusion:
            be = block_expansion
            self.kp_occlusion = nn.ModuleList([
                DownBlock2d(cout, be), DownBlock2d(be, be * 2), DownBlock2d(be * 2, be * 3),
                DownBlock2d(be * 3, be * 4), conv2d(be * 4, num_kp, 4, stride=4),
            ])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.scale_factor != 1:
            x = antialias_downsample(x, self.scale_factor)
        feature_map = self.predictor(x)
        prediction = self.kp(feature_map)  # (B, K, h, w)
        b, k, h, w = prediction.shape
        heatmap = torch.softmax(prediction.reshape(b, k, h * w) / self.temperature, dim=2)
        heatmap = heatmap.reshape(b, k, h, w)
        out = {"kp": gaussian2kp(heatmap)}
        if self.jacobian is not None:
            jacobian_map = self.jacobian(feature_map)  # (B, 4, h, w)
            dt = torch.promote_types(heatmap.dtype, jacobian_map.dtype)
            jac = torch.einsum("bkhw,bchw->bkc", heatmap.to(dt), jacobian_map.to(dt))
            out["jacobian"] = jac.reshape(b, k, 2, 2)
        if self.kp_occlusion is not None:
            occ = feature_map
            for blk in self.kp_occlusion:
                occ = blk(occ)
            out["kp_occlusion"] = torch.sigmoid(occ)
        return out


class TPSKPDetector(nn.Module):
    """The TPSM prior's keypoint detector: a ResNet-18 to num_tps x 5
    keypoints in [-1, 1]."""

    def __init__(self, num_tps: int = 10):
        super().__init__()
        self.num_tps = num_tps
        self.fg_encoder = ResNet18(num_outputs=num_tps * 5 * 2)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        fg_kp = torch.sigmoid(self.fg_encoder(image)) * 2.0 - 1.0
        return {"kp": fg_kp.reshape(image.shape[0], self.num_tps * 5, 2)}
