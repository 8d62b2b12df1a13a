"""The yardstick's arithmetic, frozen here: the H100's peaks, the bytes and
operations each hand kernel must move and do at a shape (copied from the
port's `tools/kernel_times.py`), a kernel's roofline bound, and the model
FLOPs of a step counted over the reference.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 3.35 TB/s of
HBM3; 989 TFLOP/s in bf16 on the tensor cores; 67 TFLOP/s in float32
outside them (TF32 is off in every cell).
"""
from __future__ import annotations

from typing import Callable

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
F32_FLOPS_PER_S = PEAK_FLOPS_PER_S["float32"]
ITEMSIZE = {"float32": 4, "bfloat16": 2}
WIN = 7  # the lookup's window side
LOOKUP_CHANNELS = 2 * WIN * WIN  # 98: two levels of 7x7


def lookup_bytes(bq: int, map_side: int, itemsize: int) -> int:
    """Bytes a lookup of `bq` queries must move when every query's window
    lies inside its maps (a smooth flow inside the frame): each query's 8x8
    patch of both levels read once (level 1 is map_side / 2 wide, and a
    patch is never wider than its map), the f32 coords read, the output
    written."""
    patch = sum(min(8, map_side >> level) ** 2 for level in (0, 1))
    return bq * patch * itemsize + bq * 2 * 4 + bq * LOOKUP_CHANNELS * itemsize


def lookup_flops(bq: int) -> int:
    """f32 operations of the lookup: per output 4 weight products, 4 tap
    products and 3 sums; per query and level the fractions and their
    complements (4), and the level-1 halving of the centre (2)."""
    return bq * (LOOKUP_CHANNELS * 11 + 2 * 4 + 2)


def splat_bytes(b: int, n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """Bytes the splat must move: g read once, the two corners (int32) and
    four pair weights (f32) read once, d_img (f32) written once."""
    return b * n * c * itemsize + b * n * 6 * 4 + b * h * w * c * 4


def splat_flops(b: int, n: int, c: int) -> int:
    """f32 operations of the splat: per sample and channel two products
    u = wx * g, four products wy * u and four accumulating sums."""
    return b * n * c * 10


def bound_s(nbytes: int, flops: int) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the f32 peak (both kernels compute in
    f32)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def lookup_bound_s(bq: int, map_side: int, dtype: str) -> float:
    return bound_s(lookup_bytes(bq, map_side, ITEMSIZE[dtype]), lookup_flops(bq))


def splat_bound_s(b: int, res: int, c: int, dtype: str) -> float:
    """A feature warp's splat at one pyramid level: res x res samples onto a
    res x res image of c channels."""
    n = res * res
    return bound_s(splat_bytes(b, n, c, res, res, ITEMSIZE[dtype]), splat_flops(b, n, c))


def count_flops(fn: Callable[[], object]) -> int:
    """The FLOPs `fn` runs, by torch's operator formulas (the direct
    algorithm of every convolution and product, whatever kernel runs it)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())
