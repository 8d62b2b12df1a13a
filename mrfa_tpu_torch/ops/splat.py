"""The image gradient of a bilinear warp: CUDA kernel wrapper and plain version.

`splat(g, y0, wy0, wy1, x0, wx0, wx1, h, w)` replaces the TPU kernel
mrfa_tpu/ops/pallas_splat.py::_splat_kernel (oracle `sampler._splat`):

    d_img[b, y, x, c] = sum_n WY[b, n, y] * WX[b, n, x] * g[b, n, c]

with WY / WX the weighted one-hot pairs of each sample (wy0 at row y0, wy1 at
y0 + 1; likewise along x). Indices are clipped to [-1, size], so taps outside
the image drop. The pair weights are cast to g's dtype and u = wx * g is
rounded to it before the f32 accumulation, as in the JAX package. On CUDA
tensors it launches `csrc/splat.cu` (built at first use) or raises; on CPU
tensors it runs `splat_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from mrfa_tpu_torch.ops.cuda_build import CudaLibrary

_DTYPES = (torch.float32, torch.bfloat16)


def _taps(g, y0, wy0, wy1, x0, wx0, wx1, h, w, acc):
    """The four (row, column, term) taps of every sample: indices clipped to
    [-1, size], terms wy * round(wx * g) in `acc`, (B, N, C) each."""
    dt = g.dtype
    ya = y0.long().clamp(-1, h)
    yb = (ya + 1).clamp(-1, h)
    xa = x0.long().clamp(-1, w)
    xb = (xa + 1).clamp(-1, w)
    ua = wx0.to(dt)[..., None] * g  # rounded to g's dtype, as the JAX splat's u
    ub = wx1.to(dt)[..., None] * g
    wya = wy0.to(dt).to(acc)[..., None]
    wyb = wy1.to(dt).to(acc)[..., None]
    return [
        (ya, xa, wya * ua.to(acc)),
        (ya, xb, wya * ub.to(acc)),
        (yb, xa, wyb * ua.to(acc)),
        (yb, xb, wyb * ub.to(acc)),
    ]


def splat_plain(g, y0, wy0, wy1, x0, wx0, wx1, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (`index_add_`): (B, h, w, C) f32.
    (On the CPU it also takes f64 g and weights, and then sums in f64.)"""
    b, n, c = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    # one spare row past the image takes every tap that falls outside it
    out = torch.zeros(b * h * w + 1, c, dtype=acc, device=g.device)
    base = torch.arange(b, device=g.device)[:, None] * (h * w)
    for y, x, term in _taps(g, y0, wy0, wy1, x0, wx0, wx1, h, w, acc):
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        row = torch.where(inside, base + y * w + x, b * h * w)
        out.index_add_(0, row.reshape(-1), term.reshape(-1, c))
    return out[:-1].reshape(b, h, w, c)


def _check(g, y0, wy0, wy1, x0, wx0, wx1, h, w) -> None:
    if g.dim() != 3:
        raise ValueError(f"want g (B, N, C), got {tuple(g.shape)}")
    f64 = g.dtype == torch.float64 and g.device.type == "cpu"  # plain version only
    if g.dtype not in _DTYPES and not f64:
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    wt = torch.float64 if f64 else torch.float32
    bn = tuple(g.shape[:2])
    for name, t, dt in (("y0", y0, torch.int32), ("x0", x0, torch.int32),
                        ("wy0", wy0, wt), ("wy1", wy1, wt), ("wx0", wx0, wt), ("wx1", wx1, wt)):
        if tuple(t.shape) != bn:
            raise ValueError(f"{name} must be (B, N) = {bn}, got {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != g.device:
            raise ValueError(f"{name} lies on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if h < 1 or w < 1:
        raise ValueError(f"image size must be positive, got {h}x{w}")


class Splat:
    """Callable wrapper around the CUDA kernel, with its launch count."""

    name = "splat"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary(
            "splat.cu",
            {
                "mrfa_splat": (
                    [ctypes.c_void_p] * 8
                    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                    ctypes.c_int,
                )
            },
        )

    def __call__(self, g, y0, wy0, wy1, x0, wx0, wx1, h: int, w: int) -> torch.Tensor:
        """(B, N, C) g, (B, N) int32 corners and f32 pair weights -> (B, h, w, C) f32."""
        _check(g, y0, wy0, wy1, x0, wx0, wx1, h, w)
        if g.device.type == "cpu":
            return splat_plain(g, y0, wy0, wy1, x0, wx0, wx1, h, w)
        if g.device.type != "cuda":
            raise ValueError(f"splat runs on cuda or cpu, not {g.device}")
        b, n, c = g.shape
        out = torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
        if b * n * c == 0:  # nothing to launch
            return out
        lib = self.library.load()
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mrfa_splat(
                g.data_ptr(), y0.data_ptr(), wy0.data_ptr(), wy1.data_ptr(),
                x0.data_ptr(), wx0.data_ptr(), wx1.data_ptr(), out.data_ptr(),
                b, n, c, h, w, int(g.dtype == torch.bfloat16), stream,
            )
        if rc != 0:
            raise RuntimeError(f"splat kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


splat = Splat()
