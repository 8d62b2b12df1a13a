"""VGG19 perceptual feature extractor (for the pyramid perceptual loss), NCHW.

Counterpart of mrfa_tpu/nn/vgg.py: the reference's five relu slices of
torchvision's vgg19.features (relu1_1, relu2_1, relu3_1, relu4_1, relu5_1)
with ImageNet mean/std normalization. Convolutions are named
`features_<torchvision index>`, so `utils.convert.load_jax_variables` maps
them onto the JAX package's `vgg` subtree. The module is frozen.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nn.blocks import conv2d

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# torchvision vgg19.features conv indices per slice, with output channels
_SLICE_CONVS = [
    [(0, 64)],
    [(2, 64), (5, 128)],
    [(7, 128), (10, 256)],
    [(12, 256), (14, 256), (16, 256), (19, 512)],
    [(21, 512), (23, 512), (25, 512), (28, 512)],
]
# indices after which a 2x2 max-pool runs
_POOL_AFTER = {4, 9, 18, 27}


class Vgg19(nn.Module):
    """Returns the 5 relu-slice activations for (B, 3, H, W) images in [0, 1]."""

    def __init__(self):
        super().__init__()
        cin = 3
        for convs in _SLICE_CONVS:
            for idx, cout in convs:
                setattr(self, f"features_{idx}", conv2d(cin, cout, 3, padding=1))
                cin = cout
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = (x - self.mean) / self.std
        outs = []
        prev = -1
        for convs in _SLICE_CONVS:
            for idx, _ in convs:
                for p in range(prev + 1, idx):  # any pool between two convs
                    if p in _POOL_AFTER:
                        x = F.max_pool2d(x, 2)
                x = F.relu(getattr(self, f"features_{idx}")(x))
                prev = idx
            outs.append(x)
        return outs
