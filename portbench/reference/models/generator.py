"""Occlusion-aware encoder/decoder generator, NCHW.

Counterpart of mrfa_tpu/models/generator.py: `encode` returns the source
feature pyramid coarsest-first; `decode` merges the per-scale warped features
gated by occlusion maps, concatenated with the prior-warped ("coarse")
features, and composites the final RGB with the warped full-resolution image
through the finest occlusion map.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from portbench.reference.nn.blocks import (
    ChannelBlock2d,
    DownBlock2d,
    ResBlock2d,
    SameBlock2d,
    UpBlock2d,
    conv2d,
)


def pyramid_channels(block_expansion=64, max_features=512, num_up_blocks=5) -> List[int]:
    """Channels of `encode`'s outputs, coarsest first."""
    chans = [block_expansion] + [
        min(max_features, block_expansion * (2 ** (i + 1))) for i in range(num_up_blocks)
    ]
    return chans[::-1]


class OcclusionAwareGenerator(nn.Module):
    def __init__(self, num_channels=3, block_expansion=64, max_features=512,
                 num_up_blocks=5, coarse_branch=True):
        """`coarse_branch`: build the channel blocks that merge the
        prior-warped features (RaftFlow without `prior_only`)."""
        super().__init__()
        be, mf, n = block_expansion, max_features, num_up_blocks
        self.num_up_blocks = n
        self.first = SameBlock2d(num_channels, be, kernel_size=7, padding=3)
        down, ins, outs = [], [], []
        for i in range(n):
            cin, cout = min(mf, be * (2**i)), min(mf, be * (2 ** (i + 1)))
            down.append(DownBlock2d(cin, cout))
            ins.append(cin)
            outs.append(cout)
        self.down_blocks = nn.ModuleList(down)
        # decoder stacks run coarsest-first
        self.up_blocks = nn.ModuleList(
            UpBlock2d(cout, cin) for cin, cout in zip(reversed(ins), reversed(outs))
        )
        self.resblock = nn.ModuleList(ResBlock2d(c) for c in reversed(outs))
        if coarse_branch:
            self.channel_block = nn.ModuleList(ChannelBlock2d(2 * c) for c in reversed(outs))
        self.final = conv2d(be, num_channels, 7, padding=3)

    def encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, C, H, W) -> feature pyramid, coarsest (H/2^n) first."""
        out = self.first(x)
        feats = [out]
        for blk in self.down_blocks:
            out = blk(out)
            feats.append(out)
        return feats[::-1]

    def decode(
        self,
        warp_f: List[torch.Tensor],
        warp_img: torch.Tensor,
        occlusion: List[torch.Tensor],
        warp_f_c: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        out = warp_f[0] * occlusion[0]
        if warp_f_c is not None:
            out = torch.cat([out, warp_f_c[0]], dim=1)
        for i in range(self.num_up_blocks):
            if warp_f_c is not None:
                out = self.channel_block[i](out)
            out = self.up_blocks[i](self.resblock[i](out))
            occ = occlusion[i + 1]
            out = warp_f[i + 1] * occ + out * (1.0 - occ)
            if warp_f_c is not None and i != self.num_up_blocks - 1:
                out = torch.cat([out, warp_f_c[i + 1]], dim=1)
        out = torch.sigmoid(self.final(out))
        return out * (1.0 - occlusion[-1]) + warp_img * occlusion[-1]
