"""The correlation window lookup and its backward, plain PyTorch: a frozen
copy of the port's plain versions (mrfa_tpu_torch/ops/corr_lookup.py).

Channel l*49 + i*7 + j is the bilinear sample of level l at
(cx/2^l + i - 3, cy/2^l + j - 3), zeros outside the map.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RADIUS = 3
WIN = 2 * RADIUS + 1
CHANNELS = 2 * WIN * WIN  # 98

_DTYPES = (torch.float32, torch.bfloat16)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic dtype: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _geometry(centres: torch.Tensor, h: int, w: int):
    """Per query: the window's clamped integer corner x0, y0 (BQ,) and the
    bilinear fractions fx, fy (BQ, 1, 1) of the unclamped centre."""
    x0f = torch.floor(centres[:, 0])
    y0f = torch.floor(centres[:, 1])
    fx = (centres[:, 0] - x0f)[:, None, None]
    fy = (centres[:, 1] - y0f)[:, None, None]
    # clamped like the kernels: past this range the whole window is outside
    x0 = x0f.clamp(-(RADIUS + 2), w + RADIUS).long()
    y0 = y0f.clamp(-(RADIUS + 2), h + RADIUS).long()
    return x0, y0, fx, fy


def _level_plain(maps: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    """(BQ, h, w) maps, (BQ, 2) centres -> (BQ, 49) window samples (f32, or
    f64 for f64 maps)."""
    bq, h, w = maps.shape
    flat = maps.to(_acc(maps.dtype)).reshape(bq, h * w)
    x0, y0, fx, fy = _geometry(centres, h, w)
    gx = 1.0 - fx
    gy = 1.0 - fy
    d = torch.arange(-RADIUS, RADIUS + 1, device=maps.device)
    xs = x0[:, None, None] + d[None, :, None]  # x offset on the first axis
    ys = y0[:, None, None] + d[None, None, :]

    def tap(x, y):
        x, y = torch.broadcast_tensors(x, y)
        valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        idx = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        return flat.gather(1, idx.reshape(bq, -1)).reshape(bq, WIN, WIN) * valid

    out = gx * gy * tap(xs, ys)
    out = out + fx * gy * tap(xs + 1, ys)
    out = out + gx * fy * tap(xs, ys + 1)
    out = out + fx * fy * tap(xs + 1, ys + 1)
    return out.reshape(bq, WIN * WIN)


def corr_lookup_plain(c0: torch.Tensor, c1: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 blend, result in the maps'
    dtype. (On the CPU it also takes f64 maps and coords, and then computes
    in f64.)"""
    out = torch.cat([_level_plain(c0, coords), _level_plain(c1, coords * 0.5)], dim=1)
    return out.to(c0.dtype)


def _level_bwd_plain(maps: torch.Tensor, centres: torch.Tensor, g: torch.Tensor):
    """One level's backward: (BQ, h, w) maps, (BQ, 2) centres, (BQ, 7, 7)
    cotangent [x offset, y offset] in the arithmetic dtype -> (d_map
    (BQ, h, w), dcx, dcy (BQ,)) in that dtype."""
    bq, h, w = maps.shape
    acc = g.dtype
    x0, y0, fx, fy = _geometry(centres, h, w)
    gx = 1.0 - fx
    gy = 1.0 - fy
    d = torch.arange(-RADIUS, RADIUS + 2, device=maps.device)  # the 8x8 patch
    xs, ys = torch.broadcast_tensors(x0[:, None, None] + d[None, :, None],
                                     y0[:, None, None] + d[None, None, :])
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    idx = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).reshape(bq, -1)
    p8 = maps.to(acc).reshape(bq, h * w).gather(1, idx).reshape(bq, WIN + 1, WIN + 1) * inside
    # a.e. derivatives of the blend; p8 is [x tap, y tap]
    ddx = gy * (p8[:, 1:, :WIN] - p8[:, :WIN, :WIN]) + fy * (p8[:, 1:, 1:] - p8[:, :WIN, 1:])
    ddy = gx * (p8[:, :WIN, 1:] - p8[:, :WIN, :WIN]) + fx * (p8[:, 1:, 1:] - p8[:, 1:, :WIN])
    dcx = (g * ddx).sum((1, 2))
    dcy = (g * ddy).sum((1, 2))
    # cotangent patch: the four fraction-weighted shifts of g (pad = (y lo,
    # y hi, x lo, x hi))
    d8 = (gx * gy * F.pad(g, (0, 1, 0, 1)) + fx * gy * F.pad(g, (0, 1, 1, 0))
          + gx * fy * F.pad(g, (1, 0, 0, 1)) + fx * fy * F.pad(g, (1, 0, 1, 0)))
    # one spare column past the map takes the patch taps outside it
    dmap = torch.zeros(bq, h * w + 1, dtype=acc, device=maps.device)
    dmap.scatter_(1, torch.where(inside.reshape(bq, -1), idx, h * w), d8.reshape(bq, -1))
    return dmap[:, :-1].reshape(bq, h, w), dcx, dcy


def corr_lookup_bwd_plain(c0: torch.Tensor, c1: torch.Tensor, coords: torch.Tensor,
                          g: torch.Tensor):
    """Plain PyTorch version of the backward kernel: (d_c0, d_c1) in the maps'
    dtype, zero outside each query's 8x8 patch, and f32 d_coords (BQ, 2)."""
    g = g.to(_acc(c0.dtype)).reshape(-1, 2, WIN, WIN)
    d0, dcx0, dcy0 = _level_bwd_plain(c0, coords, g[:, 0])
    d1, dcx1, dcy1 = _level_bwd_plain(c1, coords * 0.5, g[:, 1])
    dc = torch.stack([dcx0 + 0.5 * dcx1, dcy0 + 0.5 * dcy1], dim=-1)
    return d0.to(c0.dtype), d1.to(c1.dtype), dc


class CorrLookupFn(torch.autograd.Function):
    """Differentiable lookup: the plain forward and the plain backward."""

    @staticmethod
    def forward(ctx, c0, c1, coords):
        ctx.save_for_backward(c0, c1, coords)
        return corr_lookup_plain(c0, c1, coords)

    @staticmethod
    def backward(ctx, g):
        c0, c1, coords = ctx.saved_tensors
        return corr_lookup_bwd_plain(c0, c1, coords, g)
