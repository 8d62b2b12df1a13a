"""MTIA prior encoder: HRNet trunk + TokenPose transformer head.

Counterpart of mrfa_tpu/models/tokenpose.py: the 1/4-resolution HRNet feature
is cut into 4x4 patches, 2K learned query tokens (K keypoint + K jacobian
tokens) are prepended, a ViT with per-head scaling and a GELU MLP runs over
them, and the fixed sine position embedding is re-added to the image tokens
before every layer after the first. Heads: LayerNorm + Linear ->
2*sigmoid(kp)-1, and a jacobian head initialized to the identity.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.models.hrnet import HRNetBase
from portbench.reference.nn.norm import LayerNorm


def sine_position_embedding(h: int, w: int, d_model: int) -> np.ndarray:
    """2-D sine position embedding, (1, h*w, d_model), reference layout."""
    scale = 2 * math.pi
    eps = 1e-6
    area = np.ones((1, h, w), dtype=np.float32)
    y_embed = area.cumsum(1)
    x_embed = area.cumsum(2)
    one_dir = d_model // 2
    y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = np.arange(one_dir, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / one_dir)
    pos_x = x_embed[:, :, :, None] / dim_t
    pos_y = y_embed[:, :, :, None] / dim_t
    pos_x = np.stack((np.sin(pos_x[:, :, :, 0::2]), np.cos(pos_x[:, :, :, 1::2])), axis=4)
    pos_x = pos_x.reshape(*pos_x.shape[:3], -1)
    pos_y = np.stack((np.sin(pos_y[:, :, :, 0::2]), np.cos(pos_y[:, :, :, 1::2])), axis=4)
    pos_y = pos_y.reshape(*pos_y.shape[:3], -1)
    pos = np.concatenate((pos_y, pos_x), axis=3)  # (1,h,w,d)
    return pos.reshape(1, h * w, d_model)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5  # per-head scaling
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(dim, dim))

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = (
            t.reshape(b, n, self.heads, -1).transpose(1, 2)
            for t in self.to_qkv(x).chunk(3, dim=-1)
        )
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * self.scale, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return self.to_out(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        # reference layout: Linear, GELU, Dropout, Linear, Dropout
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(), nn.Identity(),
            nn.Linear(hidden_dim, dim), nn.Identity(),
        )

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads, mlp_dim, num_keypoints, all_attn=True):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.all_attn = all_attn
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Residual(PreNorm(dim, Attention(dim, heads))),
                Residual(PreNorm(dim, FeedForward(dim, mlp_dim))),
            ])
            for _ in range(depth)
        )

    def forward(self, x, pos):
        nk = self.num_keypoints
        for d, (attn, ff) in enumerate(self.layers):
            if d > 0 and self.all_attn:
                x = torch.cat([x[:, :nk], x[:, nk:] + pos], dim=1)
            x = ff(attn(x))
        return x


class TokenPoseTB(nn.Module):
    """Transformer head over patchified HRNet features ("transformer" in torch)."""

    def __init__(self, feature_size=64, patch_size=4, num_keypoints=10, dim=192,
                 depth=12, heads=8, mlp_ratio=3, channels=32, estimate_jacobian=True):
        super().__init__()
        self.patch_size = patch_size
        fh = feature_size // patch_size
        self.nk = 2 * num_keypoints  # jacobian tokens double the query count
        self.keypoint_token = nn.Parameter(torch.empty(1, self.nk, dim))
        nn.init.trunc_normal_(self.keypoint_token, std=0.02, a=-0.04, b=0.04)
        self.register_buffer(
            "pos", torch.from_numpy(sine_position_embedding(fh, fh, dim)), persistent=False
        )
        self.patch_to_embedding = nn.Linear(patch_size * patch_size * channels, dim)
        self.transformer = Transformer(dim, depth, heads, dim * mlp_ratio, num_keypoints=self.nk)
        self.mlp_head = nn.Sequential(LayerNorm(dim), nn.Linear(dim, 2))
        self.estimate_jacobian = estimate_jacobian
        if estimate_jacobian:
            self.mlp_head_jacobian = nn.Sequential(LayerNorm(dim), nn.Linear(dim, 4))
            nn.init.zeros_(self.mlp_head_jacobian[1].weight)
            with torch.no_grad():
                self.mlp_head_jacobian[1].bias.copy_(torch.tensor([1.0, 0.0, 0.0, 1.0]))

    def forward(self, feature: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, c, fh, fw = feature.shape
        p = self.patch_size
        # patchify with (p1, p2, c) ordering inside each patch
        x = feature.reshape(b, c, fh // p, p, fw // p, p)
        x = x.permute(0, 2, 4, 3, 5, 1).reshape(b, (fh // p) * (fw // p), p * p * c)
        x = self.patch_to_embedding(x)
        n = x.shape[1]
        x = x + self.pos[:, :n]
        x = torch.cat([self.keypoint_token.expand(b, -1, -1), x], dim=1)
        x = self.transformer(x, self.pos)
        half = self.nk // 2
        out = {"kp": 2.0 * torch.sigmoid(self.mlp_head(x[:, :half])) - 1.0}
        if self.estimate_jacobian:
            jac = self.mlp_head_jacobian(x[:, half:self.nk])
            out["jacobian"] = jac.reshape(b, half, 2, 2)
        return out


class TokenPoseB(nn.Module):
    """Full MTIA encoder: HRNet trunk ("pre_feature") + TokenPose head."""

    def __init__(self, num_keypoints=10, dim=192, depth=12, heads=8, mlp_ratio=3,
                 image_size=256, patch_size=4, base_channel=32, estimate_jacobian=True):
        super().__init__()
        self.pre_feature = HRNetBase()
        self.transformer = TokenPoseTB(
            feature_size=image_size // 4, patch_size=patch_size,
            num_keypoints=num_keypoints, dim=dim, depth=depth, heads=heads,
            mlp_ratio=mlp_ratio, channels=base_channel,
            estimate_jacobian=estimate_jacobian,
        )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.transformer(self.pre_feature(x))
