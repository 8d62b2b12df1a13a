"""Conv blocks and Hourglass, NCHW.

Counterpart of mrfa_tpu/nn/blocks.py (the blocks of the reference's
modules/util.py). Attribute names are the reference torch paths, so
`state_dict()` keys map onto the JAX parameter tree (utils/convert.py).
The JAX package's `SpaceToDepthConv` and `TapsConv` are TPU re-associations of
a plain convolution with the same (k, k, in, out) kernel; here they are
`nn.Conv2d`.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.nn.norm import BatchNorm
from portbench.reference.ops.resize import avg_pool, upsample_nearest


def conv2d(in_features, out_features, kernel_size, stride=1, padding=0, groups=1,
           bias=True) -> nn.Conv2d:
    return nn.Conv2d(
        in_features, out_features, kernel_size, stride=stride, padding=padding,
        groups=groups, bias=bias,
    )


class SameBlock2d(nn.Module):
    """conv -> BN -> relu, preserving resolution."""

    def __init__(self, in_features, out_features, kernel_size=3, padding=1, groups=1):
        super().__init__()
        self.conv = conv2d(in_features, out_features, kernel_size, padding=padding,
                           groups=groups)
        self.norm = BatchNorm(out_features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class DownBlock2d(nn.Module):
    """conv -> BN -> relu -> 2x average pool."""

    def __init__(self, in_features, out_features, kernel_size=3, padding=1, groups=1):
        super().__init__()
        self.conv = conv2d(in_features, out_features, kernel_size, padding=padding,
                           groups=groups)
        self.norm = BatchNorm(out_features)

    def forward(self, x):
        return avg_pool(F.relu(self.norm(self.conv(x))), 2)


class UpBlock2d(nn.Module):
    """2x nearest upsample -> conv -> BN -> relu."""

    def __init__(self, in_features, out_features, kernel_size=3, padding=1, groups=1):
        super().__init__()
        self.conv = conv2d(in_features, out_features, kernel_size, padding=padding,
                           groups=groups)
        self.norm = BatchNorm(out_features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(upsample_nearest(x, 2))))


class ResBlock2d(nn.Module):
    """Pre-activation residual block preserving channels and resolution."""

    def __init__(self, features, kernel_size=3, padding=1):
        super().__init__()
        self.norm1 = BatchNorm(features)
        self.conv1 = conv2d(features, features, kernel_size, padding=padding)
        self.norm2 = BatchNorm(features)
        self.conv2 = conv2d(features, features, kernel_size, padding=padding)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return out + x


class ChannelBlock2d(nn.Module):
    """BN -> relu -> conv halving the channel count."""

    def __init__(self, in_features, kernel_size=3, padding=1):
        super().__init__()
        self.norm1 = BatchNorm(in_features)
        self.conv1 = conv2d(in_features, in_features // 2, kernel_size, padding=padding)

    def forward(self, x):
        return self.conv1(F.relu(self.norm1(x)))


class Encoder(nn.Module):
    """Hourglass encoder: num_blocks DownBlocks, doubling channels to a cap."""

    def __init__(self, block_expansion, in_features, num_blocks=3, max_features=256):
        super().__init__()
        blocks = []
        for i in range(num_blocks):
            cin = in_features if i == 0 else min(max_features, block_expansion * (2**i))
            cout = min(max_features, block_expansion * (2 ** (i + 1)))
            blocks.append(DownBlock2d(cin, cout, kernel_size=3, padding=1))
        self.down_blocks = nn.ModuleList(blocks)

    def forward(self, x) -> List[torch.Tensor]:
        outs = [x]
        for blk in self.down_blocks:
            outs.append(blk(outs[-1]))
        return outs


class Decoder(nn.Module):
    """Hourglass decoder with skip concatenation."""

    def __init__(self, block_expansion, in_features, num_blocks=3, max_features=256):
        super().__init__()
        blocks = []
        for i in reversed(range(num_blocks)):
            cin = (1 if i == num_blocks - 1 else 2) * min(
                max_features, block_expansion * (2 ** (i + 1))
            )
            cout = min(max_features, block_expansion * (2**i))
            blocks.append(UpBlock2d(cin, cout, kernel_size=3, padding=1))
        self.up_blocks = nn.ModuleList(blocks)
        self.out_filters = block_expansion + in_features

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        feats = list(feats)
        out = feats.pop()
        for blk in self.up_blocks:
            out = torch.cat([blk(out), feats.pop()], dim=1)
        return out


class Hourglass(nn.Module):
    """U-Net with skip concatenation (encoder + decoder)."""

    def __init__(self, block_expansion, in_features, num_blocks=3, max_features=256):
        super().__init__()
        self.encoder = Encoder(block_expansion, in_features, num_blocks, max_features)
        self.decoder = Decoder(block_expansion, in_features, num_blocks, max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        return self.decoder(self.encoder(x))
