"""HRNet-W32 feature trunk of the MTIA keypoint encoder, NCHW.

Counterpart of mrfa_tpu/models/hrnet.py (stem stride 4, one Bottleneck stage,
2- and 3-branch BASIC stages with exchange units, one 32-channel output at
1/4 resolution). Module paths are the reference's, e.g.
`stage2.0.fuse_layers.1.0.0.0` (None where the reference has no module).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nn.blocks import conv2d
from portbench.reference.nn.norm import BatchNorm
from portbench.reference.ops.resize import upsample_nearest


def _conv_bn(cin, cout, kernel_size, stride=1, relu=False) -> nn.Sequential:
    layers = [
        conv2d(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2, bias=False),
        BatchNorm(cout),
    ]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = _conv_bn(inplanes, planes, 1, stride) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = _conv_bn(inplanes, out, 1, stride) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class HighResolutionModule(nn.Module):
    """Parallel branches of BasicBlocks followed by full exchange fusion."""

    def __init__(self, num_branches: int, num_blocks: Sequence[int],
                 num_channels: Sequence[int], multi_scale_output: bool = True):
        super().__init__()
        self.num_branches = num_branches
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(num_channels[i], num_channels[i])
                            for _ in range(num_blocks[i])])
            for i in range(num_branches)
        )
        fuse = []
        if num_branches > 1:
            for i in range(num_branches if multi_scale_output else 1):
                row = []
                for j in range(num_branches):
                    if j > i:  # 1x1 conv + BN, then nearest upsample 2^(j-i)
                        row.append(_conv_bn(num_channels[j], num_channels[i], 1))
                    elif j == i:
                        row.append(None)
                    else:  # (i-j) stride-2 3x3 conv steps
                        steps = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            cout = num_channels[i] if last else num_channels[j]
                            steps.append(_conv_bn(num_channels[j], cout, 3, 2, relu=not last))
                        row.append(nn.Sequential(*steps))
                fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.num_branches == 1:
            return xs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = xs[j]
                elif j > i:
                    t = upsample_nearest(layer(xs[j]), 2 ** (j - i))
                else:
                    t = layer(xs[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


class HRNetBase(nn.Module):
    """HRNet trunk: stem(/4) -> bottleneck stage -> 2-branch -> 3-branch."""

    def __init__(self, stage2_num_modules=1, stage2_num_blocks=(4, 4),
                 stage2_num_channels=(32, 64), stage3_num_modules=4,
                 stage3_num_blocks=(4, 4, 4), stage3_num_channels=(32, 64, 128)):
        super().__init__()
        c2, c3 = list(stage2_num_channels), list(stage3_num_channels)
        self.conv1 = conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(64)
        self.conv2 = conv2d(64, 64, 3, stride=2, padding=1, bias=False)
        self.bn2 = BatchNorm(64)
        self.layer1 = nn.Sequential(
            *[Bottleneck(64 if b == 0 else 256, 64, downsample=(b == 0)) for b in range(4)]
        )
        self.transition1 = nn.ModuleList([
            _conv_bn(256, c2[0], 3, relu=True),
            nn.Sequential(_conv_bn(256, c2[1], 3, 2, relu=True)),
        ])
        self.stage2 = nn.Sequential(*[
            HighResolutionModule(2, stage2_num_blocks, c2) for _ in range(stage2_num_modules)
        ])
        self.transition2 = nn.ModuleList(
            [None, None, nn.Sequential(_conv_bn(c2[1], c3[2], 3, 2, relu=True))]
        )
        self.stage3 = nn.Sequential(*[
            HighResolutionModule(3, stage3_num_blocks, c3,
                                 multi_scale_output=m != stage3_num_modules - 1)
            for m in range(stage3_num_modules)
        ])

    def forward(self, x) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        xs = self.stage2(xs)
        xs = [xs[0], xs[1], self.transition2[2](xs[-1])]
        return self.stage3(xs)[0]  # (B, 32, H/4, W/4)
