"""Evaluation metrics: L1, PSNR, LPIPS, NCHW.

Counterpart of mrfa_tpu/metrics.py (the reference reconstruction harness).
`LpipsVgg` is LPIPS(net='vgg'): unit-normalized VGG16 features (relu1_2 ..
relu5_3, convolutions named `features_<torchvision index>`), squared
differences weighted per channel by `lin<i>` or, without the learned
weights, averaged over channels. No LPIPS weights are in the repository:
`evals.reconstruction` then warns and uses the uniform variant.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mrfa_tpu_torch.nn.blocks import conv2d


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def psnr(a: torch.Tensor, b: torch.Tensor, pixel_max: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 20.0 * torch.log10(pixel_max / torch.sqrt(mse))


# VGG16 conv indices per slice (torchvision .features), with output channels
_VGG16_SLICES = [
    [(0, 64), (2, 64)],
    [(5, 128), (7, 128)],
    [(10, 256), (12, 256), (14, 256)],
    [(17, 512), (19, 512), (21, 512)],
    [(24, 512), (26, 512), (28, 512)],
]
_VGG16_POOL_AFTER = {4, 9, 16, 23}
# lpips's ScalingLayer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LpipsVgg(nn.Module):
    """LPIPS distance of (B, 3, H, W) image pairs -> (B,).

    `normalize=False` (the default) matches the reference harness: it feeds
    [0, 1] images straight into lpips's scaling layer, which expects
    [-1, 1]. `normalize=True` maps [0, 1] to [-1, 1] first.
    """

    def __init__(self, use_linear_weights: bool = True, normalize: bool = False):
        super().__init__()
        self.normalize = normalize
        cin = 3
        for convs in _VGG16_SLICES:
            for idx, cout in convs:
                setattr(self, f"features_{idx}", conv2d(cin, cout, 3, padding=1))
                cin = cout
        self.use_linear_weights = use_linear_weights
        if use_linear_weights:
            for i, convs in enumerate(_VGG16_SLICES):
                c = convs[-1][1]
                setattr(self, f"lin{i}", nn.Parameter(torch.full((c,), 1.0 / c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def features(self, img: torch.Tensor):
        if self.normalize:
            img = 2.0 * img - 1.0
        z = (img - self.shift) / self.scale
        outs = []
        prev = -1
        for convs in _VGG16_SLICES:
            for idx, _ in convs:
                for p in range(prev + 1, idx):
                    if p in _VGG16_POOL_AFTER:
                        z = F.max_pool2d(z, 2)
                z = F.relu(getattr(self, f"features_{idx}")(z))
                prev = idx
            outs.append(z)
        return outs

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(x), self.features(y))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            d = (a - b) ** 2  # (B, C, H, W)
            if self.use_linear_weights:
                dist = torch.sum(d * getattr(self, f"lin{i}")[:, None, None], dim=1)
            else:
                dist = torch.mean(d, dim=1)
            total = total + torch.mean(dist, dim=(1, 2))
        return total
