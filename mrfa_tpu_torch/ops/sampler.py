"""Bilinear backward warps, NCHW images, differentiable.

Counterpart of mrfa_tpu/ops/sampler.py. Every warp reduces to one bilinear
sample at float pixel coordinates, `warp_pixels(img, ix, iy, zero_oob)`, an
autograd Function as the JAX package's `_bilinear_core` custom VJP:
  - forward: the `warp_bilinear` kernel (`csrc/warp_bilinear.cu`, B7), one
    launch for the XLA gather and f32 blend of the JAX forward; on CPU
    tensors its plain version `warp_pixels_plain` (a gather of the four
    taps from a zero-padded copy, the same blend);
  - d_img: the splat kernel (`ops/splat.py`, for the TPU kernel
    `pallas_splat.py::_splat_kernel`), launched only when the image needs a
    gradient: warps of an input image (the dense-motion source warps, the
    final image warp, the equivariance transform of the driving frame) need
    d_coords alone;
  - d_ix, d_iy: from the re-gathered taps, only the fraction weights carry a
    derivative.
`grid_sample` gives torch `F.grid_sample` semantics (zeros, border and
reflection padding) on normalized grids; with zero padding the kernel maps
the grid to pixels itself. `sample_pixel` samples pixel coordinates
directly, as the JAX package does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from mrfa_tpu_torch.ops.cuda_build import CudaLibrary
from mrfa_tpu_torch.ops.splat import splat

_DTYPES = (torch.float32, torch.bfloat16)


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


def warp_pixels_plain(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                      zero_oob: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, C, H, W), (B, N) pixel
    coordinates -> (B, C, N) in img's dtype; taps in img's dtype, f32
    weights and blend (f64 for f64 inputs, on the CPU)."""
    h, w = img.shape[-2:]
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


def _unnorm_terms(size: int, align_corners: bool):
    """(a, b, c) with _unnormalize(g) = ((g + 1) * a - b) * c, operation for
    operation, as the kernel computes it."""
    if align_corners:
        return 0.5, 0.0, float(size - 1)
    return float(size), 1.0, 0.5


class _WarpArgs(ctypes.Structure):
    """csrc/warp_bilinear.cu's WarpArgs, field for field."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in ("img", "ix", "iy", "out")]
        + [(k, ctypes.c_int64) for k in (
            "b", "c", "h", "w", "n", "img_sb", "img_sc", "img_sh", "img_sw",
            "ix_sb", "ix_sn", "iy_sb", "iy_sn", "out_sb", "out_sc", "out_sn")]
        + [(k, ctypes.c_float) for k in ("ax", "bx", "cx", "ay", "by", "cy")]
        + [(k, ctypes.c_int32) for k in ("unnorm", "zero_oob", "is_bf16")]
    )


def _check(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> None:
    if (img.dim() != 4 or ix.dim() != 2 or tuple(ix.shape) != tuple(iy.shape)
            or ix.shape[0] != img.shape[0]):
        raise ValueError(f"want img (B, C, H, W) and ix, iy (B, N); got {tuple(img.shape)}, "
                         f"{tuple(ix.shape)}, {tuple(iy.shape)}")
    on_cpu = img.device.type == "cpu"  # the plain version also takes f64
    if img.dtype not in _DTYPES and not (on_cpu and img.dtype == torch.float64):
        raise TypeError(f"img must be float32 or bfloat16, got {img.dtype}")
    coords = (torch.float32, torch.float64) if on_cpu else (torch.float32,)
    if ix.dtype not in coords or iy.dtype != ix.dtype:
        raise TypeError(f"ix and iy must be float32, got {ix.dtype} and {iy.dtype}")
    if ix.device != img.device or iy.device != img.device:
        raise ValueError(f"img, ix and iy must lie on one device, got {img.device}, "
                         f"{ix.device}, {iy.device}")


class WarpBilinear:
    """Callable wrapper around the CUDA kernel, with its launch count."""

    name = "warp_bilinear"

    def __init__(self):
        self.launches = 0
        self._lib = None
        self.library = CudaLibrary(
            "warp_bilinear.cu",
            {
                "mrfa_warp_bilinear_args_size": ([], ctypes.c_int),
                "mrfa_warp_bilinear": ([ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
            },
        )

    def _load(self):
        """The library, its WarpArgs checked against `_WarpArgs` at the first load."""
        if self._lib is None:
            lib = self.library.load()
            size = lib.mrfa_warp_bilinear_args_size()
            if size != ctypes.sizeof(_WarpArgs):
                raise RuntimeError(f"csrc/warp_bilinear.cu's WarpArgs has {size} bytes, "
                                   f"ops/sampler.py's {ctypes.sizeof(_WarpArgs)}")
            self._lib = lib
        return self._lib

    def __call__(self, img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                 zero_oob: bool = True, align_corners: Optional[bool] = None) -> torch.Tensor:
        """(B, C, H, W) img, (B, N) ix, iy -> (B, C, N) in img's dtype. With
        `align_corners` set, ix and iy are normalized grid values, mapped to
        pixels as `F.grid_sample` maps them."""
        _check(img, ix, iy)
        b, c, h, w = img.shape
        if img.device.type == "cpu":
            if align_corners is not None:
                ix = _unnormalize(ix, w, align_corners)
                iy = _unnormalize(iy, h, align_corners)
            return warp_pixels_plain(img, ix, iy, zero_oob)
        if img.device.type != "cuda":
            raise ValueError(f"warp_bilinear runs on cuda or cpu, not {img.device}")
        n = ix.shape[1]
        out = torch.empty((b, c, n), dtype=img.dtype, device=img.device)
        if out.numel() == 0:  # nothing to launch
            return out
        terms = ((1.0, 0.0, 1.0) * 2 if align_corners is None
                 else _unnorm_terms(w, align_corners) + _unnorm_terms(h, align_corners))
        args = _WarpArgs(
            img.data_ptr(), ix.data_ptr(), iy.data_ptr(), out.data_ptr(), b, c, h, w, n,
            *img.stride(), *ix.stride(), *iy.stride(), *out.stride(), *terms,
            align_corners is not None, zero_oob, img.dtype == torch.bfloat16,
        )
        lib = self._load()
        with torch.cuda.device(img.device):
            rc = lib.mrfa_warp_bilinear(ctypes.byref(args),
                                        torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"warp_bilinear kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


warp_bilinear = WarpBilinear()


class _BilinearWarp(torch.autograd.Function):
    """Bilinear sample of (B, C, H, W) at (B, N) coordinates -> (B, C, N):
    pixel coordinates, or normalized ones with `align_corners` set."""

    @staticmethod
    def forward(ctx, img, ix, iy, zero_oob: bool, align_corners: Optional[bool]):
        ctx.save_for_backward(img, ix, iy)
        ctx.zero_oob = zero_oob
        ctx.align_corners = align_corners
        return warp_bilinear(img, ix, iy, zero_oob, align_corners)

    @staticmethod
    def backward(ctx, g):
        img, ix, iy = ctx.saved_tensors
        h, w = img.shape[-2:]
        ac = ctx.align_corners
        if ac is not None:  # the forward mapped a normalized grid to pixels
            ix, iy = _unnormalize(ix, w, ac), _unnormalize(iy, h, ac)
        x0, y0, wx, wy, vx0, vx1, vy0, vy1 = _tap_weights(ix, iy, h, w, ctx.zero_oob)
        d_img = d_ix = d_iy = None
        if ctx.needs_input_grad[0]:
            d_img = splat(
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
            if ac is not None:  # through ((g + 1) * a - b) * c, as autograd would
                (ax, _, cx), (ay, _, cy) = _unnorm_terms(w, ac), _unnorm_terms(h, ac)
                d_ix, d_iy = d_ix * cx * ax, d_iy * cy * ay
        return d_img, d_ix, d_iy, None, None


def warp_pixels(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                zero_oob: bool = True, align_corners: Optional[bool] = None) -> torch.Tensor:
    """Bilinear sample of (B, C, H, W) at float pixel coordinates ix, iy (B, N)
    -> (B, C, N). With `zero_oob`, corners outside the image contribute zero
    (torch padding_mode='zeros'); otherwise the coordinates must already lie
    in the image (border and reflection fold them first). With
    `align_corners` set, ix and iy are normalized grid values instead."""
    return _BilinearWarp.apply(img, ix, iy, zero_oob, align_corners)


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
    if padding_mode == "zeros":  # the kernel maps the grid to pixels itself
        return warp_pixels(img, g[..., 0], g[..., 1], True, align_corners).reshape(b, c, *sdims)
    ix = _unnormalize(g[..., 0], w, align_corners)
    iy = _unnormalize(g[..., 1], h, align_corners)
    if padding_mode == "border":
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
