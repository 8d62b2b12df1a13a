"""The splat kernel's algorithm on the CPU: its bins and its owner-computes
accumulation (`mrfa_tpu_torch/ops/splat.py`), held against a brute-force
enumeration, the direct scatter `splat_plain`, and the JAX package's splat
(`sampler._splat`, and the Pallas kernel in interpret mode)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfa_tpu.ops import sampler as jsampler
from mrfa_tpu.ops.pallas_splat import splat_pallas
from mrfa_tpu_torch.ops.splat import (
    TILE_H,
    TILE_W,
    Splat,
    splat_binned_plain,
    splat_bins_plain,
    splat_plain,
    tile_grid,
)


def _corners(rng, flow, b, n, h, w):
    """int32 corners (y0, x0) of n samples a batch: `smooth` a flow of a few
    pixels around a grid, `wild` over the image and 3 px beyond every edge,
    `collapse` all within a pixel of one point, `edges` only -1 and the
    size and their neighbours."""
    grid = np.arange(n)
    if flow == "smooth":
        gy, gx = (grid // w) % h, grid % w
        y = gy + 3 * np.sin(gx / 5.0 + rng.rand(b, 1) * 6)
        x = gx + 3 * np.cos(gy / 7.0 + rng.rand(b, 1) * 6)
    elif flow == "wild":
        y = rng.uniform(-4, h + 3, (b, n))
        x = rng.uniform(-4, w + 3, (b, n))
    elif flow == "collapse":
        y = h / 3 + rng.uniform(-1, 1, (b, n))
        x = w / 3 + rng.uniform(-1, 1, (b, n))
    else:  # edges
        y = rng.choice([-2, -1, 0, h - 1, h, h + 1], (b, n))
        x = rng.choice([-2, -1, 0, w - 1, w, w + 1], (b, n))
    return np.floor(y).astype(np.int32), np.floor(x).astype(np.int32)


def _case(rng, flow, b, n, c, h, w):
    y0, x0 = _corners(rng, flow, b, n, h, w)
    g = rng.randn(b, n, c).astype(np.float32)
    ws = [rng.rand(b, n).astype(np.float32) for _ in range(4)]
    return g, y0, ws[0], ws[1], x0, ws[2], ws[3]


def _brute_bins(y0, x0, h, w):
    """Per bin, the set of samples b * N + n one of whose four clipped taps
    lies in the image and in the bin's tile."""
    b, n = y0.shape
    nty, ntx = tile_grid(h, w)
    bins = [set() for _ in range(b * nty * ntx)]
    for i in range(b):
        for j in range(n):
            ya = min(max(int(y0[i, j]), -1), h)
            xa = min(max(int(x0[i, j]), -1), w)
            ys = (ya, min(max(ya + 1, -1), h))
            xs = (xa, min(max(xa + 1, -1), w))
            for y, x in itertools.product(ys, xs):
                if 0 <= y < h and 0 <= x < w:
                    bins[(i * nty + y // TILE_H) * ntx + x // TILE_W].add(i * n + j)
    return bins


@pytest.mark.parametrize("flow,b,n,h,w", [("smooth", 2, 700, 40, 23), ("wild", 2, 500, 33, 48),
                                          ("collapse", 3, 300, 37, 37), ("edges", 2, 400, 32, 17)])
def test_bins_hold_exactly_the_tiles_each_sample_touches(flow, b, n, h, w):
    y0, x0 = _corners(np.random.RandomState(n), flow, b, n, h, w)
    counts, members = splat_bins_plain(torch.from_numpy(y0), torch.from_numpy(x0), h, w)
    want = _brute_bins(y0, x0, h, w)
    assert counts.tolist() == [len(s) for s in want]
    got = torch.split(members, counts.tolist())
    assert all(g.tolist() == sorted(s) for g, s in zip(got, want))
    # a sample lies in at most four bins; the CPU wrapper gives the same bins
    assert members.numel() <= 4 * b * n
    cpu = Splat().bins(torch.from_numpy(y0), torch.from_numpy(x0), h, w)
    assert torch.equal(cpu[0], counts) and torch.equal(cpu[1], members)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("flow,b,n,c,h,w", [("smooth", 2, 920, 64, 40, 23),
                                            ("wild", 2, 600, 3, 33, 48),
                                            ("collapse", 2, 500, 8, 37, 37),
                                            ("edges", 1, 400, 5, 32, 17)])
def test_owner_accumulation_matches_the_scatter_and_jax_f32(flow, b, n, c, h, w):
    args = _case(np.random.RandomState(n), flow, b, n, c, h, w)
    got = splat_binned_plain(*map(_t, args), h, w).numpy()
    assert got.shape == (b, h, w, c)
    assert _rel(got, splat_plain(*map(_t, args), h, w).numpy()) <= 1e-6
    assert _rel(got, np.asarray(jsampler._splat(*map(jnp.asarray, args), h, w))) <= 1e-5


def test_owner_accumulation_matches_the_pallas_kernel():
    """Against the TPU kernel in interpret mode, which takes lane-aligned
    channels and corners already clipped to [-1, size]."""
    h = w = 32
    args = list(_case(np.random.RandomState(3), "smooth", 2, 1024, 64, h, w))
    args[1], args[4] = np.clip(args[1], -1, h), np.clip(args[4], -1, w)
    got = splat_binned_plain(*map(_t, args), h, w).numpy()
    kernel = np.asarray(splat_pallas(*map(jnp.asarray, args), h, w, interpret=True))
    assert _rel(got, kernel) <= 1e-5


def test_owner_accumulation_matches_jax_bf16():
    """bf16 g: pair weights cast to bf16, u = wx * g rounded to bf16, f32
    sums, as the XLA splat (tests/test_torch_train_ops.py)."""
    args = list(_case(np.random.RandomState(5), "wild", 2, 900, 64, 32, 40))
    gb = jnp.asarray(args[0], jnp.bfloat16)
    want = np.asarray(jsampler._splat(gb, *map(jnp.asarray, args[1:]), 32, 40), np.float32)
    tg = torch.from_numpy(np.asarray(gb.astype(jnp.float32))).to(torch.bfloat16)
    got = splat_binned_plain(tg, *map(_t, args[1:]), 32, 40)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4
    assert _rel(got.numpy(), splat_plain(tg, *map(_t, args[1:]), 32, 40).numpy()) <= 1e-6
