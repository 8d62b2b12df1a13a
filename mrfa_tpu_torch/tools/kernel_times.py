"""Times the splat and the lookup forward at every main-path shape on the card.

    python mrfa_tpu_torch/tools/kernel_times.py [--tree DIR] [--label NAME] [--stream]

With `--tree`, the kernels timed are those of the port in DIR (another
checkout of this repository, for example a `git archive` of an earlier
commit unpacked under `build/`), built from DIR's sources into DIR's
`build/`; the inputs, bounds and timing are this file's. Comparing two trees
on one card means one command that runs this script for each, in turns
(A, B, B, A). It prints one JSON line per timed case and, last, the per-path
sums: Σ launches × ms against Σ launches × bound, training per step,
serving per frame and reconstruction per chunk. The script needs a CUDA
device and fails without one.

`chip_smoke.py` takes its inputs, bounds and timing helpers from here.

The shapes: the training step's 17 feature-warp splats a step (B=10; three
at each pyramid level from 8 to 128 px, two at 256 px, whose coarse warp is
not computed), on a flow of a few pixels of white noise around the identity
(`noisy`) and on a smooth one (`smooth`); the lookup's six calls a frame
(B=1: BQ 64, 256, 1024 and three at 4096), a step (B=10: 640, 2560, 10240
and three at 40960) and a reconstruction chunk (`evals.reconstruction`,
frame_batch 8: 512, 2048, 8192 and three at 32768). Bounds: the larger of
the bytes each call must move over 3.35 TB/s and its f32 operations over 67
TFLOP/s (H100 SXM data sheet).

With `--stream` it times the streaming probe instead (`stream_probe`, both
levels of 64x64 f32 maps at BQ 4096 and 16384, qb=16): the kernel and two
yardsticks after the same flush, the torch.stack of the kept corners (the
same output from fewer bytes) and `l0.sum(); l1.sum()` (every byte of both
levels read once, as the probe must), and at BQ 16384 the kernel back to
back without a flush.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (same sheet)
MAP_SIZE = 64  # level-0 maps are (size/4)^2 at 256 px
TRAIN_BATCH = 10
# (resolution, channels) of the pyramid levels the training step warps, and
# the splats a step at each
SPLAT_SHAPES = ((8, 512), (16, 512), (32, 512), (64, 256), (128, 128), (256, 64))
SPLATS_PER_STEP = {8: 3, 16: 3, 32: 3, 64: 3, 128: 3, 256: 2}
LOOKUPS_PER_FRAME = {64: 1, 256: 1, 1024: 1, 4096: 3}  # B=1
LOOKUPS_PER_STEP = {640: 1, 2560: 1, 10240: 1, 40960: 3}  # B=10
LOOKUPS_PER_EVAL_CHUNK = {512: 1, 2048: 1, 8192: 1, 32768: 3}  # B=8
FLOWS = ("noisy", "smooth", "wild", "collapse")
STREAM_BQS = (4096, 16384)  # the stream probe's default and the lookup probe's largest
STREAM_QB = 16  # queries per block of the TPU probe's streaming


def lookup_inputs(bq: int, dtype, device, seed: int):
    """Level maps (level 1 = 2x2 mean of level 0), made on the card from a
    seed, and coords around a grid of centres, with exact integer centres and
    partly and fully out-of-bounds windows mixed in."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(seed)
    c0 = torch.randn(bq, MAP_SIZE, MAP_SIZE, generator=gen, device=device)
    c1 = F.avg_pool2d(c0[:, None], 2)[:, 0]
    side = int(np.ceil(np.sqrt(bq)))
    idx = torch.arange(bq, device=device)
    grid = torch.stack([idx % side, idx // side], -1).float() * (MAP_SIZE / side)
    coords = grid + 2.0 * torch.randn(bq, 2, generator=gen, device=device)
    n = bq // 8
    coords[:n] = torch.round(coords[:n])  # integer centres
    coords[n:2 * n] = torch.rand(n, 2, generator=gen, device=device) * (MAP_SIZE + 24) - 12
    coords[2 * n:2 * n + 4] = torch.tensor(
        [[-40.0, 5.0], [MAP_SIZE + 30.0, 20.0], [10.0, -50.0], [-9.0, -9.0]], device=device)
    return c0.to(dtype).contiguous(), c1.to(dtype).contiguous(), coords.contiguous()


def sample_coords(res: int, flow: str, gen, device, batch: int = TRAIN_BATCH):
    """(B, res^2) pixel coordinates of a warp's samples: `noisy` the identity
    grid plus 2 px of white noise, `smooth` plus a low-frequency flow of up
    to max(2, res/16) px, `wild` uniform over the image and 2 px beyond it,
    `collapse` every sample within a pixel of one point (one full bin)."""
    import torch
    import torch.nn.functional as F

    n = res * res
    idx = torch.arange(n, device=device)
    gx, gy = (idx % res).float(), (idx // res).float()
    if flow == "noisy":
        return (gx + 2.0 * torch.randn(batch, n, generator=gen, device=device),
                gy + 2.0 * torch.randn(batch, n, generator=gen, device=device))
    if flow == "smooth":
        coarse = torch.rand(batch, 2, 4, 4, generator=gen, device=device) * 2 - 1
        d = F.interpolate(coarse, size=(res, res), mode="bilinear", align_corners=True)
        d = d.reshape(batch, 2, n) * max(2.0, res / 16)
        return gx + d[:, 0], gy + d[:, 1]
    if flow == "wild":
        return tuple(torch.rand(batch, n, generator=gen, device=device) * (res + 4) - 2
                     for _ in range(2))
    if flow == "collapse":
        return tuple(res / 3 + torch.rand(batch, n, generator=gen, device=device) * 2 - 1
                     for _ in range(2))
    raise ValueError(f"unknown flow {flow!r}")


def splat_inputs(res: int, c: int, dtype, device, seed: int, flow: str = "noisy"):
    """The arguments a feature warp's backward hands the splat at this
    pyramid level: a (B, res^2, C) gradient and the corners and pair weights
    of the coordinates of `flow`, as `ops.sampler` computes them."""
    import torch

    from mrfa_tpu_torch.ops.sampler import _tap_weights

    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(TRAIN_BATCH, res * res, c, generator=gen, device=device).to(dtype)
    ix, iy = sample_coords(res, flow, gen, device)
    x0, y0, wx, wy, vx0, vx1, vy0, vy1 = _tap_weights(ix, iy, res, res, True)
    args = (g, y0.contiguous(), ((1.0 - wy) * vy0).contiguous(), (wy * vy1).contiguous(),
            x0.contiguous(), ((1.0 - wx) * vx0).contiguous(), (wx * vx1).contiguous(), res, res)
    return args, ix, iy


HOST_AHEAD_CYCLES = 2_000_000  # ~1 ms of card clock


def cuda_ms(fn, iters: int, flush) -> float:
    """Mean device time of `fn` over `iters` runs, each after an L2 flush.
    The card sleeps ~1 ms after each flush, so that the host has enqueued
    all of `fn`'s launches before the first one runs: the time is the
    card's, not the host's gaps between launches (as on the training path,
    where the host runs far ahead of the card)."""
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def patch_bytes(coords, itemsize: int) -> int:
    """Bytes of the map values inside each query's two 8x8 patches (read once)."""
    import torch

    total = 0
    for level in (0, 1):
        size = MAP_SIZE >> level
        lo = torch.floor(coords.double() * (0.5 ** level)) - 3  # (BQ, 2) patch start
        inside = ((lo + 8).clamp(max=size) - lo.clamp(min=0)).clamp(min=0)
        total += int((inside[:, 0] * inside[:, 1]).sum()) * itemsize
    return total


def lookup_bytes(bq: int, coords, itemsize: int) -> int:
    """Bytes the lookup must move for these coords: the patch values read
    once, the coords read, the output written."""
    return patch_bytes(coords, itemsize) + bq * 2 * 4 + bq * 98 * itemsize


def lookup_flops(bq: int) -> int:
    """f32 operations of the lookup: per output 4 weight products, 4 tap
    products and 3 sums; per query and level the fractions and their
    complements (4), and the level-1 halving of the centre (2)."""
    return bq * (98 * 11 + 2 * 4 + 2)


def splat_bytes(b: int, n: int, c: int, h: int, w: int, itemsize: int) -> int:
    """Bytes the splat must move: g read once, the two corners (int32) and
    four pair weights (f32) read once, d_img (f32) written once."""
    return b * n * c * itemsize + b * n * 6 * 4 + b * h * w * c * 4


def splat_flops(b: int, n: int, c: int) -> int:
    """f32 operations of the splat: per sample and channel two products
    u = wx * g, four products wy * u and four accumulating sums."""
    return b * n * c * 10


def bound(nbytes: int, flops: int) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "flops": flops, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def stream_levels(bq: int, device, seed: int, size: int = MAP_SIZE):
    """The stream probe's two levels: (BQ*size, size) maps from a seed and
    their 2x2 mean, (BQ*size/2, size/2), both f32 on the card."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(seed)
    corr = torch.randn(bq, size, size, generator=gen, device=device)
    l1 = F.avg_pool2d(corr[:, None], 2)[:, 0]
    return corr.reshape(bq * size, size), l1.reshape(bq * size // 2, size // 2).contiguous()


def stream_bytes(bq: int, levels) -> int:
    """Bytes the stream probe must move: every byte of its levels read once,
    the (2, BQ*8, 8) f32 output written once."""
    return sum(lv.numel() * lv.element_size() for lv in levels) + 2 * bq * 8 * 8 * 4


def stream_library(l0, l1, bq: int, qb: int = STREAM_QB):
    """The probe's output as one torch.stack of the kept corners' strided
    views: equal output, but it reads only the corners."""
    import torch

    nb, n = bq // qb, 8 * qb
    views = [lv.view(nb, lv.shape[0] // nb, lv.shape[1])[:, :n, :8] for lv in (l0, l1)]
    return torch.stack(views).view(2, bq * 8, 8)


def stream_same_bytes(l0, l1):
    """A library read of the probe's bytes: every byte of both levels once."""
    return l0.sum(), l1.sum()


def back_to_back_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` runs back to back, no flush."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_stream(probe, plain, bq: int, device, seed: int, qb: int = STREAM_QB,
                iters: int = 20, flush=None) -> dict:
    """The stream probe's row at `bq`: kernel, plain and both library times
    after the flush, its bound and rate; the kernel and the same-bytes read
    after a reading flush; at BQ >= 16384 (344 MB, far beyond the 50 MB L2)
    also both back to back without a flush."""
    l0, l1 = stream_levels(bq, device, seed)
    flush = flush or make_flush(device)
    read_flush = make_read_flush(device)
    nbytes = stream_bytes(bq, (l0, l1))
    ms = cuda_ms(lambda: probe(l0, l1, bq, qb), iters, flush)
    row = {
        "shape": f"bq={bq} {MAP_SIZE}x{MAP_SIZE} qb={qb}", "ms": ms,
        "plain_ms": cuda_ms(lambda: plain(l0, l1, bq, qb), iters // 2, flush),
        # equal output from the corners alone (fewer bytes than the probe's)
        "library_ms": cuda_ms(lambda: stream_library(l0, l1, bq, qb), iters // 2, flush),
        # every byte of both levels read once, as the probe reads them
        "library_same_bytes_ms": cuda_ms(lambda: stream_same_bytes(l0, l1), iters, flush),
        **bound(nbytes, 0),
        "gb_per_s": nbytes / ms / 1e6,
        # both after a flush that leaves no dirty line in the L2
        "ms_read_flush": cuda_ms(lambda: probe(l0, l1, bq, qb), iters, read_flush),
        "library_same_bytes_ms_read_flush": cuda_ms(lambda: stream_same_bytes(l0, l1), iters,
                                                    read_flush),
    }
    if bq >= 16384:
        row["ms_back_to_back"] = back_to_back_ms(lambda: probe(l0, l1, bq, qb), iters)
        row["library_same_bytes_ms_back_to_back"] = back_to_back_ms(
            lambda: stream_same_bytes(l0, l1), iters)
    return row


def make_flush(device):
    """An L2 flush: zero 256 MB (> the 50 MB L2)."""
    import torch

    buf = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=device)
    return buf.zero_


def make_read_flush(device):
    """An L2 flush that reads 256 MB and leaves the L2 clean: after the
    zeroing flush, the dirty lines it leaves are written back while the
    timed kernel runs."""
    import torch

    buf = torch.zeros(64 * 1024 * 1024, dtype=torch.float32, device=device)
    return buf.sum


def time_shapes(splat, lookup, device, dtypes, flows=("noisy", "smooth"), iters: int = 20):
    """Kernel ms and bound of `splat` at the six splat shapes (each flow) and
    of `lookup` at the twelve lookup BQs; one row per case."""
    import torch

    flush = make_flush(device)
    rows = []
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        for j, (res, c) in enumerate(SPLAT_SHAPES):
            for flow in flows:
                args, _, _ = splat_inputs(res, c, dtype, device, seed=11 + j, flow=flow)
                n = res * res
                rows.append({
                    "kernel": "splat", "dtype": name, "flow": flow, "res": res, "c": c,
                    "ms": cuda_ms(lambda: splat(*args), iters, flush),
                    **bound(splat_bytes(TRAIN_BATCH, n, c, res, res, args[0].element_size()),
                            splat_flops(TRAIN_BATCH, n, c)),
                })
                del args
        for i, bq in enumerate(tuple(LOOKUPS_PER_FRAME) + tuple(LOOKUPS_PER_STEP)
                               + tuple(LOOKUPS_PER_EVAL_CHUNK)):
            c0, c1, coords = lookup_inputs(bq, dtype, device, seed=10 + i)
            rows.append({
                "kernel": "corr_lookup", "dtype": name, "bq": bq,
                "ms": cuda_ms(lambda: lookup(c0, c1, coords), iters * 2, flush),
                **bound(lookup_bytes(bq, coords, c0.element_size()), lookup_flops(bq)),
            })
        torch.cuda.synchronize()
    return rows


def profile_splat(splat, device, dtype, cases=((256, 64, "smooth"), (64, 256, "smooth"),
                                               (8, 512, "smooth")), calls: int = 5):
    """Device time by kernel of `calls` splat calls (torch.profiler), per
    call: the binning, cumsum and accumulating kernels apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = []
    for res, c, flow in cases:
        args, _, _ = splat_inputs(res, c, dtype, device, seed=5, flow=flow)
        splat(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                splat(*args)
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
            if t > 0 and not e.key.startswith(("aten::", "cuda")):
                by_name[e.key[:90]] = t / calls / 1e3
        out.append({"kernel": "splat profile", "dtype": str(dtype).split(".")[-1], "res": res,
                    "c": c, "flow": flow, "ms_by_kernel": by_name})
    return out


def path_sums(rows, flow: str = "smooth") -> dict:
    """Σ launches × ms and Σ launches × bound_ms per path and dtype: the
    splat (on `flow`) and the lookup a training step, the lookup a frame and
    a reconstruction chunk."""
    sums = {}
    for r in rows:
        if r["kernel"] == "splat" and r["flow"] == flow:
            keys = [("training_step", SPLATS_PER_STEP[r["res"]])]
        elif r["kernel"] == "corr_lookup":
            keys = [("training_step", LOOKUPS_PER_STEP.get(r["bq"], 0)),
                    ("serving_frame", LOOKUPS_PER_FRAME.get(r["bq"], 0)),
                    ("eval_chunk", LOOKUPS_PER_EVAL_CHUNK.get(r["bq"], 0))]
        else:
            continue
        for path, count in keys:
            if not count:
                continue
            s = sums.setdefault(f"{path} {r['kernel']} {r['dtype']}",
                                {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
            s["launches"] += count
            s["ms"] += count * r["ms"]
            s["bound_ms"] += count * r["bound_ms"]
    return sums


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                        help="root of the checkout whose kernels are timed")
    parser.add_argument("--label", default=None, help="name printed on every line")
    parser.add_argument("--stream", action="store_true",
                        help="time the streaming probe instead of the splat and lookup")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import mrfa_tpu_torch
    from mrfa_tpu_torch.ops.corr_lookup import corr_lookup
    from mrfa_tpu_torch.ops.splat import splat

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label or args.tree
    print(json.dumps({"label": label, "package": str(Path(mrfa_tpu_torch.__file__).parent),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    if args.stream:
        from mrfa_tpu_torch.ops.stream_probe import stream_probe, stream_probe_plain

        for bq in STREAM_BQS:
            row = time_stream(stream_probe, stream_probe_plain, bq, torch.device("cuda"), seed=13)
            print(json.dumps({"label": label, "kernel": "stream_probe", **row}), flush=True)
        return 0
    rows = time_shapes(splat, corr_lookup, torch.device("cuda"),
                       (torch.float32, torch.bfloat16))
    for r in rows:
        print(json.dumps({"label": label, **r}))
    for dtype in (torch.float32, torch.bfloat16):
        for r in profile_splat(splat, torch.device("cuda"), dtype):
            print(json.dumps({"label": label, **r}))
    print(json.dumps({"label": label, "sums": path_sums(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
