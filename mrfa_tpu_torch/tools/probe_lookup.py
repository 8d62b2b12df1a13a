"""Timing probe of the pooled correlation lookup and its two backward routes.

Counterpart of tools/probe_lookup.py (and of tools/probe_device_time.py's use
of the pooled backward). For each query count: per-query 64x64 maps and
coordinates uniform in [-8, 72], 20 distinct input sets made on the device
from seed 0;
each function runs once to warm up and then once per input set, timed with
CUDA events around the run (host clock on the CPU). It prints ms and ns per
query of the pooled forward (`corr_lookup_pooled`) and of both backward
routes (the `corr_lookup_pooled_bwd` kernel, and the two-level
`corr_lookup_bwd` kernel plus a PyTorch fold), and the largest error of each
against the port's plain gather oracle: ops/corr.py's `corr_block_lookup`
for the forward, autograd of the plain gather lookup over the pooled levels
for the backward.

    python -m mrfa_tpu_torch.tools.probe_lookup [fwd|bwd|both] [bq ...] [--device cpu]

It runs on the card unless `--device cpu` is given, and raises without CUDA.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from mrfa_tpu_torch.ops.corr import corr_block_lookup
from mrfa_tpu_torch.ops.corr_lookup import (
    CHANNELS,
    corr_lookup_plain,
    corr_lookup_pooled,
    corr_lookup_pooled_bwd,
    corr_lookup_pooled_bwd_b3,
)
from mrfa_tpu_torch.utils.device import resolve_device

MAP_SIZE = 64
N_CALLS = 20
DEFAULT_BQS = (256, 1024, 4096, 16384)


def timed_ms(fn: Callable, argsets: Sequence[tuple], device: torch.device) -> float:
    """Mean time of `fn` over the input sets, after one warm-up call: CUDA
    events around the whole run on the card, the host clock on the CPU."""
    fn(*argsets[0])
    if device.type != "cuda":
        t0 = time.perf_counter()
        for a in argsets:
            fn(*a)
        return (time.perf_counter() - t0) * 1e3 / len(argsets)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for a in argsets:
        fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(argsets)


def probe_inputs(bq: int, n: int, device: torch.device, seed: int = 0):
    """n (corr (BQ, 64, 64), coords (BQ, 2), g (BQ, 98)) f32 sets, made on
    the device from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sets = []
    for _ in range(n):
        corr = torch.randn(bq, MAP_SIZE, MAP_SIZE, generator=gen, device=device)
        coords = torch.rand(bq, 2, generator=gen, device=device) * (MAP_SIZE + 16) - 8
        g = torch.randn(bq, CHANNELS, generator=gen, device=device)
        sets.append((corr, coords, g))
    return sets


def pooled_region_bytes(coords: torch.Tensor, h: int, w: int, itemsize: int) -> int:
    """Bytes of the map values the pooled backward must read: the level-0
    region under each query's level-1 8x8 patch (16 x 16, clipped to the map),
    which holds its level-0 patch too."""
    size = torch.tensor([w, h], dtype=torch.float64, device=coords.device)
    corner = torch.floor(coords.double() * 0.5)
    corner = torch.minimum(torch.maximum(corner, torch.full_like(corner, -5.0)), size / 2 + 3)
    lo = 2 * (corner - 3)
    extent = (torch.minimum(lo + 16, size) - lo.clamp(min=0)).clamp(min=0)
    return int((extent[:, 0] * extent[:, 1]).sum()) * itemsize


def pooled_bwd_bytes(coords: torch.Tensor, h: int, w: int, itemsize: int) -> int:
    """Bytes the pooled backward must move: the map region and coords read,
    g read (f32), the whole d_corr written (each query owns its map) and
    d_coords written."""
    bq = coords.shape[0]
    return (pooled_region_bytes(coords, h, w, itemsize) + bq * 2 * 4 + bq * CHANNELS * 4
            + bq * h * w * itemsize + bq * 2 * 4)


def pooled_bwd_flops(bq: int, h: int, w: int) -> int:
    """f32 operations of the pooled backward: those of the two-level backward
    (cotangent patches 2 x 64 x 11, window-tap derivatives 98 x 12, tap sums
    2 x 98, per-level geometry 2 x 12, level combination 4), the on-the-fly
    pool of the level-1 patch (64 x 4) and the fold (2 per map value)."""
    return bq * (2 * 64 * 11 + 98 * 12 + 2 * 98 + 2 * 12 + 4 + 64 * 4 + 2 * h * w)


def pooled_fwd_bytes(bq: int, h: int, w: int, itemsize: int) -> int:
    """Bytes the pooled forward must move: every map value read (the pool
    needs them all), coords read, the (BQ, 98) output written."""
    return bq * (h * w * itemsize + 2 * 4 + CHANNELS * itemsize)


def plain_gather_bwd(corr: torch.Tensor, coords: torch.Tensor, g: torch.Tensor):
    """The oracle: autograd of the plain gather lookup over (corr, its pool)."""
    leaves = [corr.detach().clone().requires_grad_(True),
              coords.detach().clone().requires_grad_(True)]
    out = corr_lookup_plain(leaves[0], F.avg_pool2d(leaves[0], 2), leaves[1])
    return torch.autograd.grad(out, leaves, g)


def run(mode: str = "both", bqs: Sequence[int] = DEFAULT_BQS, device=None,
        calls: int = N_CALLS) -> List[Dict]:
    """Probe each query count; returns one record per (bq, function)."""
    device = resolve_device(device)
    rows = []

    def report(bq, label, ms, **errs):
        row = {"bq": bq, "fn": label, "ms": ms, "ns_per_query": ms * 1e6 / bq, **errs}
        err = " ".join(f"{k}={v:.2e}" for k, v in errs.items())
        print(f"bq={bq:6d} {label:16s}: {ms:9.4f} ms ({ms * 1e6 / bq:8.2f} ns/q)  {err}",
              flush=True)
        rows.append(row)

    for bq in bqs:
        sets = probe_inputs(bq, calls, device)
        corr, coords, g = sets[0]
        if mode in ("fwd", "both"):
            ref = corr_block_lookup(corr, coords)
            err = float((corr_lookup_pooled(corr, coords) - ref).abs().max())
            ms = timed_ms(lambda c, x, _: corr_lookup_pooled(c, x), sets, device)
            report(bq, "fwd pooled", ms, max_err=err)
        if mode in ("bwd", "both"):
            want_dc, want_dxy = plain_gather_bwd(corr, coords, g)
            for label, fn in (("bwd pooled", corr_lookup_pooled_bwd),
                              ("bwd b3+fold", corr_lookup_pooled_bwd_b3)):
                ms = timed_ms(fn, sets, device)
                dc, dxy = fn(corr, coords, g)
                report(bq, label, ms, err_dcorr=float((dc - want_dc).abs().max()),
                       err_dcoords=float((dxy - want_dxy).abs().max()))
        del sets, corr, coords, g
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", nargs="?", default="both", choices=("fwd", "bwd", "both"))
    parser.add_argument("bqs", nargs="*", type=int, default=list(DEFAULT_BQS))
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--calls", type=int, default=N_CALLS)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"probe_lookup on {name}: {args.mode}, maps {MAP_SIZE}x{MAP_SIZE} f32", flush=True)
    rows = run(args.mode, args.bqs, device, args.calls)
    print(json.dumps({"probe": "lookup", "device": name, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
