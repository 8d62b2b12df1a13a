"""Bilinear backward warps, NCHW images, differentiable.

Counterpart of mrfa_tpu/ops/sampler.py. Every warp reduces to one bilinear
sample at float pixel coordinates, `warp_pixels(img, ix, iy, zero_oob)`, an
autograd Function as the JAX package's `_bilinear_core` custom VJP:
  - forward: one gather of the four taps from a zero-padded copy and the
    f32 blend of the JAX forward (an XLA gather there, plain PyTorch here);
  - d_img: the plain splat (`ops/splat.py`), computed only when the image
    needs a gradient: warps of an input image (the dense-motion source warps, the
    final image warp, the equivariance transform of the driving frame) need
    d_coords alone;
  - d_ix, d_iy: from the re-gathered taps, only the fraction weights carry a
    derivative.
`grid_sample` gives torch `F.grid_sample` semantics (zeros, border and
reflection padding) on normalized grids; `sample_pixel` samples pixel
coordinates directly, as the JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ops.splat import splat_plain


def _tap_weights(ix, iy, h: int, w: int, zero_oob: bool):
    """Corner indices, fraction weights and per-tap validity masks, (B, N) each."""
    x0f = torch.floor(ix)
    y0f = torch.floor(iy)
    wx = ix - x0f
    wy = iy - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    if zero_oob:
        vx0 = ((x0 >= 0) & (x0 < w)).to(wx.dtype)
        vx1 = ((x0 + 1 >= 0) & (x0 + 1 < w)).to(wx.dtype)
        vy0 = ((y0 >= 0) & (y0 < h)).to(wx.dtype)
        vy1 = ((y0 + 1 >= 0) & (y0 + 1 < h)).to(wx.dtype)
    else:
        vx0 = vx1 = vy0 = vy1 = torch.ones_like(wx)
    return x0, y0, wx, wy, vx0, vx1, vy0, vy1


def _gather_taps(img, x0, y0):
    """The four corner taps p00, p10 (x + 1), p01 (y + 1), p11 of (B, C, H, W)
    at (B, N) corners (integer-valued), as one (B, C, 4, N) gather. Corners
    are clipped to [-1, size] and read from a zero-padded copy, as the JAX
    package's gather does, so taps outside the image read zero."""
    b, c, h, w = img.shape
    wp = w + 3  # padded (1, 2) on both axes: the x + 1 tap of a corner at w
    flat = F.pad(img, (1, 2, 1, 2)).reshape(b, c, (h + 3) * wp)
    lin = (y0.long().clamp(-1, h) + 1) * wp + (x0.long().clamp(-1, w) + 1)
    idx = torch.stack([lin, lin + 1, lin + wp, lin + wp + 1], dim=1)  # (B, 4, N)
    n = lin.shape[1]
    return flat.gather(2, idx.reshape(b, 1, 4 * n).expand(b, c, 4 * n)).reshape(b, c, 4, n)


class _BilinearWarp(torch.autograd.Function):
    """Bilinear sample of (B, C, H, W) at (B, N) pixel coordinates -> (B, C, N)."""

    @staticmethod
    def forward(ctx, img, ix, iy, zero_oob: bool):
        h, w = img.shape[-2:]
        ctx.save_for_backward(img, ix, iy)
        ctx.zero_oob = zero_oob
        if zero_oob:
            # beyond one pixel outside, every tap reads the zero padding: the
            # same values as the JAX blend's validity masks, with fewer ops
            ix = ix.clamp(-1.0, float(w))
            iy = iy.clamp(-1.0, float(h))
        x0f = torch.floor(ix)
        y0f = torch.floor(iy)
        wx = ix - x0f
        wy = iy - y0f
        gx = 1.0 - wx
        gy = 1.0 - wy
        weights = torch.stack([gx * gy, wx * gy, gx * wy, wx * wy], dim=1)  # (B, 4, N)
        taps = _gather_taps(img, x0f, y0f)
        return (taps * weights[:, None]).sum(2).to(img.dtype)

    @staticmethod
    def backward(ctx, g):
        img, ix, iy = ctx.saved_tensors
        h, w = img.shape[-2:]
        x0, y0, wx, wy, vx0, vx1, vy0, vy1 = _tap_weights(ix, iy, h, w, ctx.zero_oob)
        d_img = d_ix = d_iy = None
        if ctx.needs_input_grad[0]:
            d_img = splat_plain(
                g.transpose(1, 2).contiguous(), y0.contiguous(),
                ((1.0 - wy) * vy0).contiguous(), (wy * vy1).contiguous(), x0.contiguous(),
                ((1.0 - wx) * vx0).contiguous(), (wx * vx1).contiguous(), h, w,
            ).permute(0, 3, 1, 2).to(img.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            acc = torch.promote_types(g.dtype, torch.float32)
            t = (g.to(acc)[:, :, None] * _gather_taps(img, x0, y0).to(acc)).sum(1)
            t00 = t[:, 0] * vx0 * vy0
            t10 = t[:, 1] * vx1 * vy0
            t01 = t[:, 2] * vx0 * vy1
            t11 = t[:, 3] * vx1 * vy1
            d_ix = ((1.0 - wy) * (t10 - t00) + wy * (t11 - t01)).to(ix.dtype)
            d_iy = ((1.0 - wx) * (t01 - t00) + wx * (t11 - t10)).to(iy.dtype)
        return d_img, d_ix, d_iy, None


def warp_pixels(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                zero_oob: bool = True) -> torch.Tensor:
    """Bilinear sample of (B, C, H, W) at float pixel coordinates ix, iy (B, N)
    -> (B, C, N). With `zero_oob`, corners outside the image contribute zero
    (torch padding_mode='zeros'); otherwise the coordinates must already lie
    in the image (border and reflection fold them first)."""
    return _BilinearWarp.apply(img, ix, iy, zero_oob)


def _unnormalize(g: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """Map [-1, 1] to pixel coordinates along one axis of length `size`."""
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip as jnp.clip does (max, then min), so that a value exactly on a
    bound passes half its gradient, as JAX's max and min do."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _reflect(coord: torch.Tensor, twice_low: float, twice_high: float) -> torch.Tensor:
    """Reflection-fold a float coordinate into [twice_low/2, twice_high/2]."""
    if twice_low == twice_high:
        return torch.zeros_like(coord)
    mn = twice_low * 0.5
    span = (twice_high - twice_low) * 0.5
    d = coord - mn
    c = torch.where(d >= 0, d, -d)  # |d| with JAX's derivative at 0 (+1)
    extra = torch.remainder(c, span)
    flips = torch.floor(c / span)
    return torch.where(torch.remainder(flips, 2.0) == 0.0, extra + mn, span - extra + mn)


def grid_sample(
    img: torch.Tensor,
    grid: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Bilinear warp with torch `F.grid_sample` semantics.

    Args:
      img: (B, C, H, W).
      grid: (B, *S, 2) normalized xy coordinates in [-1, 1].

    Returns:
      (B, C, *S).
    """
    b, c, h, w = img.shape
    sdims = grid.shape[1:-1]
    g = grid.reshape(b, -1, 2)
    ix = _unnormalize(g[..., 0], w, align_corners)
    iy = _unnormalize(g[..., 1], h, align_corners)
    if padding_mode == "zeros":
        out = warp_pixels(img, ix, iy, True)
    elif padding_mode == "border":
        out = warp_pixels(img, _clip(ix, 0.0, w - 1.0), _clip(iy, 0.0, h - 1.0), False)
    elif padding_mode == "reflection":
        if align_corners:
            ix = _reflect(ix, 0.0, 2.0 * (w - 1))
            iy = _reflect(iy, 0.0, 2.0 * (h - 1))
        else:
            ix = _reflect(ix, -1.0, 2.0 * w - 1.0)
            iy = _reflect(iy, -1.0, 2.0 * h - 1.0)
        out = warp_pixels(img, _clip(ix, 0.0, w - 1.0), _clip(iy, 0.0, h - 1.0), False)
    else:
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    return out.reshape(b, c, *sdims)


def sample_pixel(img: torch.Tensor, coords: torch.Tensor, mask: bool = False):
    """Bilinear sample at pixel xy coordinates, zero padding.

    The reference `bilinear_sampler` normalizes pixel coordinates and samples
    with align_corners=True, which maps them back to themselves; like the JAX
    package, this samples the pixel coordinates directly.

    Args:
      img: (B, C, H, W).
      coords: (B, *S, 2) pixel-space xy coordinates.
      mask: also return the strict-interior mask (B, 1, *S) of the reference's
        `(x > -1) & (x < 1)` test on normalized coordinates.
    """
    b, c, h, w = img.shape
    sdims = coords.shape[1:-1]
    cc = coords.reshape(b, -1, 2)
    out = warp_pixels(img, cc[..., 0], cc[..., 1], True).reshape(b, c, *sdims)
    if mask:
        xg = 2.0 * cc[..., 0] / (w - 1) - 1.0
        yg = 2.0 * cc[..., 1] / (h - 1) - 1.0
        m = (xg > -1) & (xg < 1) & (yg > -1) & (yg < 1)
        return out, m.to(img.dtype).reshape(b, 1, *sdims)
    return out
