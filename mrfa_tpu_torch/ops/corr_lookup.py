"""The correlation window lookup and its backward: CUDA kernel wrappers,
their plain versions, and the autograd Function that joins them.

`corr_lookup(c0, c1, coords)` replaces the TPU kernels
mrfa_tpu/ops/pallas_kernels.py::_corr_lookup_padded_kernel (serving) and
::_corr_lookup_kernel (the training forward): the port's unpadded y-major
maps are the latter's input with x and y swapped, so one CUDA kernel,
`csrc/corr_lookup.cu`, serves both. Channel l*49 + i*7 + j is the bilinear
sample of level l at (cx/2^l + i - 3, cy/2^l + j - 3), zeros outside the map
(the semantics of ops/corr.py::corr_block_lookup_levels_gather).

`corr_lookup_bwd(c0, c1, coords, g)` replaces the lookup backward's
::_patch_extract_kernel and ::_patch_scatter_kernel with one CUDA kernel,
`csrc/corr_lookup_bwd.cu`. `CorrLookupFn` is the differentiable lookup of the
training path.

On CUDA tensors each wrapper launches its kernel (built at first use) or
raises; on CPU tensors it runs its plain PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mrfa_tpu_torch.ops.cuda_build import CudaLibrary

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


def _check(c0: torch.Tensor, c1: torch.Tensor, coords: torch.Tensor) -> None:
    if c0.dim() != 3 or c1.dim() != 3 or coords.dim() != 2 or coords.shape[1] != 2:
        raise ValueError(
            f"want c0 (BQ,h,w), c1 (BQ,h/2,w/2), coords (BQ,2); got "
            f"{tuple(c0.shape)}, {tuple(c1.shape)}, {tuple(coords.shape)}"
        )
    bq, h, w = c0.shape
    if h % 2 or w % 2 or tuple(c1.shape) != (bq, h // 2, w // 2) or coords.shape[0] != bq:
        raise ValueError(
            f"level shapes disagree: c0 {tuple(c0.shape)}, c1 {tuple(c1.shape)}, "
            f"coords {tuple(coords.shape)}"
        )
    _check_types((c0, c1), coords)


def _check_types(maps, coords: torch.Tensor) -> None:
    """The dtype, device and layout rules every lookup wrapper shares."""
    c0 = maps[0]
    f64 = c0.dtype == torch.float64 and c0.device.type == "cpu"  # plain version only
    if (c0.dtype not in _DTYPES and not f64) or any(m.dtype != c0.dtype for m in maps):
        raise TypeError(f"maps must be float32 or bfloat16, got {[m.dtype for m in maps]}")
    if coords.dtype != (torch.float64 if f64 else torch.float32):
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if any(m.device != coords.device for m in maps):
        raise ValueError("maps and coords must lie on one device")
    if not (all(m.is_contiguous() for m in maps) and coords.is_contiguous()):
        raise ValueError("maps and coords must be contiguous")


class CorrLookup:
    """Callable wrapper around the CUDA kernel, with its launch count."""

    name = "corr_lookup"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary(
            "corr_lookup.cu",
            {
                "mrfa_corr_lookup": (
                    [ctypes.c_void_p] * 4
                    + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p],
                    ctypes.c_int,
                )
            },
        )

    def __call__(self, c0: torch.Tensor, c1: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """(BQ, h, w), (BQ, h/2, w/2) maps and (BQ, 2) coords -> (BQ, 98)."""
        _check(c0, c1, coords)
        if c0.device.type == "cpu":
            return corr_lookup_plain(c0, c1, coords)
        if c0.device.type != "cuda":
            raise ValueError(f"corr_lookup runs on cuda or cpu, not {c0.device}")
        bq, h, w = c0.shape
        out = torch.empty((bq, CHANNELS), dtype=c0.dtype, device=c0.device)
        if bq == 0:  # nothing to launch
            return out
        lib = self.library.load()
        with torch.cuda.device(c0.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mrfa_corr_lookup(
                c0.data_ptr(), c1.data_ptr(), coords.data_ptr(), out.data_ptr(),
                bq, h, w, int(c0.dtype == torch.bfloat16), stream,
            )
        if rc != 0:
            raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


corr_lookup = CorrLookup()


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


class CorrLookupBwd:
    """Callable wrapper around the backward CUDA kernel, with its launch count."""

    name = "corr_lookup_bwd"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary(
            "corr_lookup_bwd.cu",
            {
                "mrfa_corr_lookup_bwd": (
                    [ctypes.c_void_p] * 7
                    + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p],
                    ctypes.c_int,
                )
            },
        )

    def __call__(self, c0: torch.Tensor, c1: torch.Tensor, coords: torch.Tensor,
                 g: torch.Tensor):
        """Maps, coords as for the lookup and (BQ, 98) g -> (d_c0, d_c1, d_coords)."""
        _check(c0, c1, coords)
        if tuple(g.shape) != (c0.shape[0], CHANNELS) or g.device != c0.device:
            raise ValueError(f"want g ({c0.shape[0]}, {CHANNELS}) on {c0.device}, got "
                             f"{tuple(g.shape)} on {g.device}")
        if c0.device.type == "cpu":
            return corr_lookup_bwd_plain(c0, c1, coords, g)
        if c0.device.type != "cuda":
            raise ValueError(f"corr_lookup_bwd runs on cuda or cpu, not {c0.device}")
        bq, h, w = c0.shape
        g32 = g.float().contiguous()
        d0 = torch.empty_like(c0)
        d1 = torch.empty_like(c1)
        dc = torch.empty((bq, 2), dtype=torch.float32, device=c0.device)
        if bq == 0:  # nothing to launch
            return d0, d1, dc
        lib = self.library.load()
        with torch.cuda.device(c0.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mrfa_corr_lookup_bwd(
                c0.data_ptr(), c1.data_ptr(), coords.data_ptr(), g32.data_ptr(),
                d0.data_ptr(), d1.data_ptr(), dc.data_ptr(),
                bq, h, w, int(c0.dtype == torch.bfloat16), stream,
            )
        if rc != 0:
            raise RuntimeError(f"corr_lookup_bwd kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return d0, d1, dc


corr_lookup_bwd = CorrLookupBwd()


class CorrLookupFn(torch.autograd.Function):
    """Differentiable lookup: the `corr_lookup` kernel forward, the
    `corr_lookup_bwd` kernel backward (plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, c0, c1, coords):
        ctx.save_for_backward(c0, c1, coords)
        return corr_lookup(c0, c1, coords)

    @staticmethod
    def backward(ctx, g):
        c0, c1, coords = ctx.saved_tensors
        return corr_lookup_bwd(c0, c1, coords, g)


# --- the pooled entry: one map per query, level 1 its 2x2 average pool ---


def _pool(corr: torch.Tensor) -> torch.Tensor:
    """(BQ, h, w) -> (BQ, h/2, w/2) 2x2 means (kernel = stride = 2)."""
    return F.avg_pool2d(corr, 2)


def _fold(d0: torch.Tensor, d1: torch.Tensor) -> torch.Tensor:
    """d0 + d1 through the 2x2 pool's transpose: each map value receives
    d1[y//2, x//2] / 4."""
    return d0 + d1.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 0.25


def _check_pooled(corr: torch.Tensor, coords: torch.Tensor, g=None) -> None:
    if (corr.dim() != 3 or corr.shape[1] % 2 or corr.shape[2] % 2 or coords.dim() != 2
            or tuple(coords.shape) != (corr.shape[0], 2)):
        raise ValueError(f"want corr (BQ, h, w) with h and w even and coords (BQ, 2), got "
                         f"{tuple(corr.shape)}, {tuple(coords.shape)}")
    _check_types((corr,), coords)
    if g is not None and (tuple(g.shape) != (corr.shape[0], CHANNELS) or g.device != corr.device):
        raise ValueError(f"want g ({corr.shape[0]}, {CHANNELS}) on {corr.device}, got "
                         f"{tuple(g.shape)} on {g.device}")


def corr_lookup_pooled_bwd_plain(corr: torch.Tensor, coords: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the pooled backward kernel: the maps in f32
    (f64 for f64 maps), level 1 pooled from them, each level's backward, and
    the fold. Returns (d_corr in corr's dtype, f32 d_coords (BQ, 2))."""
    c0 = corr.to(_acc(corr.dtype))
    g = g.to(c0.dtype).reshape(-1, 2, WIN, WIN)
    d0, dcx0, dcy0 = _level_bwd_plain(c0, coords, g[:, 0])
    d1, dcx1, dcy1 = _level_bwd_plain(_pool(c0), coords * 0.5, g[:, 1])
    dc = torch.stack([dcx0 + 0.5 * dcx1, dcy0 + 0.5 * dcy1], dim=-1)
    return _fold(d0, d1).to(corr.dtype), dc


class CorrLookupPooledBwd:
    """Callable wrapper around the pooled backward CUDA kernel
    (`csrc/corr_lookup_pooled_bwd.cu`), with its launch count."""

    name = "corr_lookup_pooled_bwd"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary(
            "corr_lookup_pooled_bwd.cu",
            {
                "mrfa_corr_lookup_pooled_bwd": (
                    [ctypes.c_void_p] * 5
                    + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p],
                    ctypes.c_int,
                )
            },
        )

    def __call__(self, corr: torch.Tensor, coords: torch.Tensor, g: torch.Tensor):
        """(BQ, h, w) maps, (BQ, 2) coords and (BQ, 98) g -> (d_corr, d_coords)."""
        _check_pooled(corr, coords, g)
        if corr.device.type == "cpu":
            return corr_lookup_pooled_bwd_plain(corr, coords, g)
        if corr.device.type != "cuda":
            raise ValueError(f"corr_lookup_pooled_bwd runs on cuda or cpu, not {corr.device}")
        bq, h, w = corr.shape
        g32 = g.float().contiguous()
        dcorr = torch.empty_like(corr)
        dc = torch.empty((bq, 2), dtype=torch.float32, device=corr.device)
        if bq == 0:  # nothing to launch
            return dcorr, dc
        lib = self.library.load()
        with torch.cuda.device(corr.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mrfa_corr_lookup_pooled_bwd(
                corr.data_ptr(), coords.data_ptr(), g32.data_ptr(), dcorr.data_ptr(),
                dc.data_ptr(), bq, h, w, int(corr.dtype == torch.bfloat16), stream,
            )
        if rc != 0:
            raise RuntimeError(f"corr_lookup_pooled_bwd kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return dcorr, dc


corr_lookup_pooled_bwd = CorrLookupPooledBwd()


def corr_lookup_pooled(corr: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """The pooled lookup's forward: (BQ, h, w) maps and (BQ, 2) coords ->
    (BQ, 98) in corr's dtype. Level 1 is `F.avg_pool2d(corr, 2)` in corr's
    dtype; both levels go through the `corr_lookup` kernel."""
    _check_pooled(corr, coords)
    return corr_lookup(corr, _pool(corr), coords)


def corr_lookup_pooled_bwd_b3(corr: torch.Tensor, coords: torch.Tensor, g: torch.Tensor):
    """The pooled backward by the other route: the two-level `corr_lookup_bwd`
    kernel on (corr, its pool) and a PyTorch fold of d_c1 through the pool's
    transpose. The same function as `corr_lookup_pooled_bwd` (in bf16 the
    pooled map and d_c1 are rounded to bf16 on the way)."""
    _check_pooled(corr, coords, g)
    d0, d1, dc = corr_lookup_bwd(corr, _pool(corr), coords, g)
    return _fold(d0.float(), d1.float()).to(corr.dtype), dc


class CorrLookupPooledFn(torch.autograd.Function):
    """Differentiable pooled lookup, the counterpart of
    mrfa_tpu/ops/pallas_kernels.py::corr_block_lookup_pallas: the
    `corr_lookup` kernel forward and the `corr_lookup_pooled_bwd` kernel
    backward (plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, corr, coords):
        ctx.save_for_backward(corr, coords)
        return corr_lookup_pooled(corr, coords)

    @staticmethod
    def backward(ctx, g):
        corr, coords = ctx.saved_tensors
        return corr_lookup_pooled_bwd(corr, coords, g)
