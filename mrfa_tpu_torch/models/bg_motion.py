"""Background affine motion predictor.

Counterpart of mrfa_tpu/models/bg_motion.py: a ResNet-18 over the
channel-concatenated (source, driving) pair whose `fc` starts at zero weights
and the identity-affine bias, so the predictor starts at the identity; the
output is a (B, 3, 3) matrix with last row [0, 0, 1].
"""
from __future__ import annotations

import torch
from torch import nn

from mrfa_tpu_torch.nn.resnet import ResNet18


class BGMotionPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.bg_encoder = ResNet18(num_outputs=6, in_channels=6)
        with torch.no_grad():
            self.bg_encoder.fc.weight.zero_()
            self.bg_encoder.fc.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]))

    def forward(self, source_image: torch.Tensor, driving_image: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) source and driving frames -> (B, 3, 3)."""
        bs = source_image.shape[0]
        pred = self.bg_encoder(torch.cat([source_image, driving_image], dim=1)).reshape(bs, 2, 3)
        last = pred.new_tensor([0.0, 0.0, 1.0]).expand(bs, 1, 3)
        return torch.cat([pred, last], dim=1)
