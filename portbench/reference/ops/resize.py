"""Resize and pooling ops with torch index conventions, NCHW.

Counterpart of mrfa_tpu/ops/resize.py. Bilinear resize applies the same
per-axis interpolation matrices as the JAX package (built once per shape and
device). Anti-aliased downsampling is the original MRFA form: a depthwise
gaussian convolution with zero padding, then a nearest subsample, done here as
one strided convolution (it computes exactly the kept pixels).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ops.grid import np_gaussian_kernel_2d


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, torch index conventions."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for d in range(out_size):
        if align_corners:
            src = d * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = max(0.0, (d + 0.5) * in_size / out_size - 0.5)
        x0 = min(int(np.floor(src)), in_size - 1)
        x1 = min(x0 + 1, in_size - 1)
        lam = src - x0
        m[d, x0] += 1.0 - lam
        m[d, x1] += lam
    return m


@functools.lru_cache(maxsize=None)
def _interp_tensor(in_size, out_size, align_corners, dtype, device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode (serving),
    # so that training may save it for the backward
    with torch.inference_mode(False):
        return torch.as_tensor(
            _interp_matrix(in_size, out_size, align_corners), dtype=dtype, device=device
        )


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to (B, C, h, w): rows first, then columns."""
    if isinstance(size, int):
        size = (size, size)
    h, w = x.shape[-2:]
    oh, ow = size
    if oh != h:
        mh = _interp_tensor(h, oh, align_corners, x.dtype, x.device)
        x = torch.matmul(mh, x)
    if ow != w:
        mw = _interp_tensor(w, ow, align_corners, x.dtype, x.device)
        x = torch.matmul(x, mw.t())
    return x


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def downsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour downsample by an integer factor (src = dst * factor)."""
    return x[..., ::factor, ::factor]


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Average pool with kernel = stride = k."""
    return F.avg_pool2d(x, k)


def gaussian_blur_kernel(sigma: float) -> np.ndarray:
    """Gaussian kernel with the reference's size rule 2*round(4*sigma)+1."""
    return np_gaussian_kernel_2d(sigma, 2 * round(sigma * 4) + 1)


@functools.lru_cache(maxsize=None)
def _blur_weight(scale: float, channels: int, dtype, device) -> torch.Tensor:
    kernel = gaussian_blur_kernel((1.0 / scale - 1.0) / 2.0)
    with torch.inference_mode(False):  # as in _interp_tensor
        k = torch.as_tensor(kernel, dtype=dtype, device=device)
        return k[None, None].expand(channels, 1, *k.shape).contiguous()


def antialias_downsample(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Gaussian blur (zero padding) then nearest subsample by 1/scale, NCHW."""
    if scale == 1.0:
        return x
    weight = _blur_weight(scale, x.shape[1], x.dtype, x.device)
    return F.conv2d(
        x, weight, stride=int(round(1.0 / scale)), padding=weight.shape[-1] // 2,
        groups=x.shape[1],
    )
