"""ResNet-18 with torchvision's structure and attribute names, NCHW.

Counterpart of mrfa_tpu/nn/resnet.py (the trunk of the background motion
predictor). Attribute names are torchvision's (`conv1`, `bn1`,
`layer1.0.conv1`, ..., `layer2.0.downsample.0`, `fc`), which are the keys of
the reference `.pth` files; `utils.convert.flax_path` folds them onto the JAX
package's names (`layer1_0`, `downsample_0`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nn.blocks import conv2d
from portbench.reference.nn.norm import BatchNorm


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, padding 1 on each side with -inf (the JAX
    package's `reduce_window`; torch pads max pools with -inf as well)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                conv2d(in_planes, planes, 1, stride=stride, bias=False), BatchNorm(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet18(nn.Module):
    """The ResNet-18 trunk, a global average pool and the `fc` head."""

    def __init__(self, num_outputs: int = 1000, in_channels: int = 3):
        super().__init__()
        self.conv1 = conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for layer_idx, planes in enumerate([64, 128, 256, 512], start=1):
            blocks = []
            for block_idx in range(2):
                stride = 2 if (layer_idx > 1 and block_idx == 0) else 1
                blocks.append(BasicBlock(cin, planes, stride))
                cin = planes
            setattr(self, f"layer{layer_idx}", nn.Sequential(*blocks))
        self.fc = nn.Linear(512, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        for layer_idx in range(1, 5):
            x = getattr(self, f"layer{layer_idx}")(x)
        return self.fc(x.mean(dim=(2, 3)))
