"""The image gradient of a bilinear warp: CUDA kernel wrapper and plain versions.

`splat(g, y0, wy0, wy1, x0, wx0, wx1, h, w)` replaces the TPU kernel
mrfa_tpu/ops/pallas_splat.py::_splat_kernel (oracle `sampler._splat`):

    d_img[b, y, x, c] = sum_n WY[b, n, y] * WX[b, n, x] * g[b, n, c]

with WY / WX the weighted one-hot pairs of each sample (wy0 at row y0, wy1 at
y0 + 1; likewise along x). Indices are clipped to [-1, size], so taps outside
the image drop. The pair weights are cast to g's dtype and u = wx * g is
rounded to it before the f32 accumulation, as in the JAX package.

The kernel (`csrc/splat.cu`) computes it owner by owner. Each sample is
binned into the bins its in-image taps touch (at most four); a bin is 2 rows
x 8 columns of pixels, the rows one warp of an accumulating block owns in
that block's 16x8 output tile. The warp adds its bin's samples into its rows
of the tile in shared memory, with no atomics, and the block writes the tile
once. Binning is two kernels (count, fill) with a torch cumsum between them,
into int32 slots sized for the worst case, with no host sync; images of at
most DIRECT_PIXELS pixels skip it. `splat_bins_plain` gives the same bins,
and `splat_binned_plain` the same owner-computes accumulation, in plain
PyTorch; `splat_plain` is the direct scatter (`index_add_`).

On CUDA tensors `splat` launches the kernels (built at first use) or raises;
on CPU tensors it runs `splat_plain`. Its `launches` counts the accumulating
kernel, `bin_launches` the binning kernels (two a call that bins).
"""
from __future__ import annotations

import ctypes

import torch

from mrfa_tpu_torch.ops.cuda_build import CudaLibrary

_DTYPES = (torch.float32, torch.bfloat16)
TILE_H, TILE_W = 2, 8  # a bin's rows and columns of pixels, as csrc/splat.cu's
# images of at most this many pixels skip the binning: each warp then takes
# every sample of its batch and keeps those with a tap in its rows
DIRECT_PIXELS = 256


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


def tile_grid(h: int, w: int):
    """(tile rows, tile columns) of an h x w image: the bins of one batch."""
    return -(-h // TILE_H), -(-w // TILE_W)


def _axis_tiles(i0: torch.Tensor, size: int, tile: int):
    """Along one axis: the tile of the clipped tap i0, and the tile of i0 + 1
    where it differs; -1 where the tap lies outside the image."""
    a = i0.long().clamp(-1, size)
    b = (a + 1).clamp(-1, size)
    a_in = (a >= 0) & (a < size)
    b_in = (b >= 0) & (b < size)
    ta = torch.where(a_in, a // tile, -1)
    tb = torch.where(b_in & (~a_in | (b // tile != ta)), b // tile, -1)
    return ta, tb


def splat_bins_plain(y0: torch.Tensor, x0: torch.Tensor, h: int, w: int):
    """The kernel's bins: (counts (B * tiles,), members) with members the
    global sample indices b * N + n of every bin, bin by bin (bin b * tiles +
    tile row * tile columns + tile column), ascending within each. A sample
    lies in the bin of every tile that one of its in-image taps falls in."""
    bsz, n = y0.shape
    nty, ntx = tile_grid(h, w)
    total = bsz * n
    tya, tyb = _axis_tiles(y0, h, TILE_H)
    txa, txb = _axis_tiles(x0, w, TILE_W)
    s = torch.arange(total, device=y0.device).reshape(bsz, n)
    first = torch.arange(bsz, device=y0.device)[:, None] * (nty * ntx)
    keys = []
    for ty in (tya, tyb):
        for tx in (txa, txb):
            valid = (ty >= 0) & (tx >= 0)
            keys.append(torch.where(valid, (first + ty * ntx + tx) * total + s, -1).reshape(-1))
    keys = torch.cat(keys)
    keys = keys[keys >= 0].sort().values
    counts = torch.bincount(keys // total, minlength=bsz * nty * ntx)
    return counts, keys % total


def splat_binned_plain(g, y0, wy0, wy1, x0, wx0, wx1, h: int, w: int) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch: each tile adds the taps of its
    bin's samples that fall in it into its own buffer, then the tiles are
    laid out as the image. The same function as `splat_plain`."""
    b, n, c = g.shape
    acc = torch.promote_types(g.dtype, torch.float32)
    nty, ntx = tile_grid(h, w)
    counts, members = splat_bins_plain(y0, x0, h, w)
    bins = torch.repeat_interleave(torch.arange(counts.numel(), device=g.device), counts)
    tile = bins % (nty * ntx)
    py = (tile // ntx) * TILE_H
    px = (tile % ntx) * TILE_W
    pix = TILE_H * TILE_W
    # each tile's buffer and one spare pixel for the taps outside it
    out = torch.zeros(counts.numel() * (pix + 1), c, dtype=acc, device=g.device)
    for y, x, term in _taps(g, y0, wy0, wy1, x0, wx0, wx1, h, w, acc):
        ys, xs = y.reshape(-1)[members], x.reshape(-1)[members]
        mine = ((ys >= py) & (ys < py + TILE_H) & (ys < h)
                & (xs >= px) & (xs < px + TILE_W) & (xs < w))
        local = torch.where(mine, (ys - py) * TILE_W + xs - px, pix)
        out.index_add_(0, bins * (pix + 1) + local, term.reshape(b * n, c)[members])
    tiles = out.reshape(b, nty, ntx, pix + 1, c)[:, :, :, :pix]
    img = tiles.reshape(b, nty, ntx, TILE_H, TILE_W, c).permute(0, 1, 3, 2, 4, 5)
    return img.reshape(b, nty * TILE_H, ntx * TILE_W, c)[:, :h, :w].contiguous()


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
    """Callable wrapper around the CUDA kernels, with their launch counts."""

    name = "splat"

    def __init__(self):
        self.launches = 0  # the accumulating kernel
        self.bin_launches = 0  # the count and fill kernels
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        self.library = CudaLibrary(
            "splat.cu",
            {
                "mrfa_splat_tile": ([i32], i32),
                "mrfa_splat_bin_count": ([ptr] * 3 + [i64, i64, i32, i32, ptr], i32),
                "mrfa_splat_bin_fill": ([ptr] * 4 + [i64, i64, i32, i32, ptr], i32),
                "mrfa_splat_accumulate": ([ptr] * 11 + [i64, i64, i32, i32, i32, i32, ptr], i32),
            },
        )

    def _load(self):
        lib = self.library.load()
        tile = (lib.mrfa_splat_tile(0), lib.mrfa_splat_tile(1))
        if tile != (TILE_H, TILE_W):
            raise RuntimeError(f"csrc/splat.cu tiles by {tile}, ops/splat.py by "
                               f"{(TILE_H, TILE_W)}")
        return lib

    def _bin(self, lib, y0, x0, h: int, w: int):
        """Count and fill the bins on the card: (counts, ends, slots)."""
        b, n = y0.shape
        nty, ntx = tile_grid(h, w)
        if 4 * b * n >= 2 ** 31 or b * nty * ntx >= 2 ** 31:
            raise ValueError(f"too many samples or tiles for int32 bins: B={b} N={n} {h}x{w}")
        counts = torch.zeros(b * nty * ntx, dtype=torch.int32, device=y0.device)
        slots = torch.empty(4 * b * n, dtype=torch.int32, device=y0.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mrfa_splat_bin_count(y0.data_ptr(), x0.data_ptr(), counts.data_ptr(),
                                      b, n, h, w, stream)
        if rc != 0:
            raise RuntimeError(f"splat bin count kernel launch failed: CUDA error {rc}")
        self.bin_launches += 1
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        cursor = ends - counts
        rc = lib.mrfa_splat_bin_fill(y0.data_ptr(), x0.data_ptr(), cursor.data_ptr(),
                                     slots.data_ptr(), b, n, h, w, stream)
        if rc != 0:
            raise RuntimeError(f"splat bin fill kernel launch failed: CUDA error {rc}")
        self.bin_launches += 1
        return counts, ends, slots

    def bins(self, y0: torch.Tensor, x0: torch.Tensor, h: int, w: int):
        """The bins as `splat_bins_plain` gives them, (counts, members), but
        in the kernel's slot order within each bin on CUDA tensors (a host
        sync: for checks, not the main path)."""
        if y0.device.type == "cpu":
            return splat_bins_plain(y0, x0, h, w)
        if y0.numel() == 0:
            return splat_bins_plain(y0.cpu(), x0.cpu(), h, w)
        with torch.cuda.device(y0.device):
            counts, ends, slots = self._bin(self._load(), y0, x0, h, w)
        return counts.long(), slots[: int(ends[-1])].long()

    def __call__(self, g, y0, wy0, wy1, x0, wx0, wx1, h: int, w: int) -> torch.Tensor:
        """(B, N, C) g, (B, N) int32 corners and f32 pair weights -> (B, h, w, C) f32."""
        _check(g, y0, wy0, wy1, x0, wx0, wx1, h, w)
        if g.device.type == "cpu":
            return splat_plain(g, y0, wy0, wy1, x0, wx0, wx1, h, w)
        if g.device.type != "cuda":
            raise ValueError(f"splat runs on cuda or cpu, not {g.device}")
        b, n, c = g.shape
        if b * n * c == 0:  # nothing to launch
            return torch.zeros((b, h, w, c), dtype=torch.float32, device=g.device)
        out = torch.empty((b, h, w, c), dtype=torch.float32, device=g.device)
        lib = self._load()
        with torch.cuda.device(g.device):
            bins = (None, None, None)
            if h * w > DIRECT_PIXELS:
                bins = tuple(t.data_ptr() for t in self._bin(lib, y0, x0, h, w))
            rc = lib.mrfa_splat_accumulate(
                g.data_ptr(), y0.data_ptr(), wy0.data_ptr(), wy1.data_ptr(),
                x0.data_ptr(), wx0.data_ptr(), wx1.data_ptr(), *bins, out.data_ptr(),
                b, n, c, h, w, int(g.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"splat kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


splat = Splat()
