"""The image gradient of a bilinear warp, plain PyTorch: a frozen copy of the
port's `splat_plain` (mrfa_tpu_torch/ops/splat.py).

    d_img[b, y, x, c] = sum_n WY[b, n, y] * WX[b, n, x] * g[b, n, c]

with WY / WX the weighted one-hot pairs of each sample. Indices are clipped
to [-1, size], so taps outside the image drop.
"""
from __future__ import annotations

import torch


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
