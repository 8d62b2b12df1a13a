"""Coordinate grids and keypoint-gaussian geometry.

Counterpart of mrfa_tpu/ops/grid.py. Grids keep the xy order in their last
axis, as `F.grid_sample` takes them; heatmaps come out channel-first.
"""
from __future__ import annotations

import numpy as np
import torch


def make_coordinate_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Normalized [-1,1] meshgrid of shape (h, w, 2), xy order.

    x varies along axis 1 (width), y along axis 0; both reach -1 and 1
    exactly (the align_corners=True convention).
    """
    x = 2.0 * (torch.arange(w, dtype=dtype, device=device) / (w - 1)) - 1.0
    y = 2.0 * (torch.arange(h, dtype=dtype, device=device) / (h - 1)) - 1.0
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def coords_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel-space identity grid of shape (h, w, 2), xy order (x = column)."""
    x = torch.arange(w, dtype=dtype, device=device)
    y = torch.arange(h, dtype=dtype, device=device)
    return torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)


def kp2gaussian(kp: torch.Tensor, spatial_size, kp_variance: float) -> torch.Tensor:
    """Keypoints (B, K, 2) in [-1, 1], xy -> gaussian heatmaps (B, K, h, w)."""
    h, w = spatial_size
    grid = make_coordinate_grid(h, w, dtype=kp.dtype, device=kp.device)
    diff = grid[None, None] - kp[:, :, None, None, :]  # (B, K, h, w, 2)
    return torch.exp(-0.5 * (diff * diff).sum(-1) / kp_variance)


def to_homogeneous(coords: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 1 to the last axis."""
    return torch.cat([coords, torch.ones_like(coords[..., :1])], dim=-1)


def from_homogeneous(coords: torch.Tensor) -> torch.Tensor:
    """Divide out the homogeneous coordinate."""
    return coords[..., :2] / coords[..., 2:3]


def np_gaussian_kernel_2d(sigma: float, kernel_size: int) -> np.ndarray:
    """Separable 2-D gaussian kernel, normalized to sum 1."""
    ax = np.arange(kernel_size, dtype=np.float64)
    mean = (kernel_size - 1) / 2.0
    k1 = np.exp(-((ax - mean) ** 2) / (2.0 * sigma**2))
    k2 = np.outer(k1, k1)
    return (k2 / k2.sum()).astype(np.float32)
