"""Streaming rates of the pooled lookup's maps on the card.

Counterpart of tools/probe_stream.py. At BQ=4096 per-query 64x64 f32 maps
(20 distinct sets from seed 0), it times and prints, each with the bytes it
must move and the rate against the H100's 3.35 TB/s:
  - the 2x2 average pool alone;
  - the streaming probe kernel over both levels (the pool precomputed);
  - the streaming probe kernel over level 0 alone;
  - the pooled lookup backward kernel (`corr_lookup_pooled_bwd`);
  - the pooled lookup forward (`corr_lookup_pooled`, pool included).
The streaming kernel's rate is that kernel's own, not the card's floor: it
reaches about half of the memory rate on an H100 (PERF.md), below what a copy
that keeps more bytes in flight would reach. Until a version of it comes near
the memory rate, the lookup kernels are held against their byte bounds, not
against it.

    python -m mrfa_tpu_torch.tools.probe_stream [--device cpu] [--bq 4096]

It runs on the card unless `--device cpu` is given, and raises without CUDA.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import torch
import torch.nn.functional as F

from mrfa_tpu_torch.ops.corr_lookup import corr_lookup_pooled, corr_lookup_pooled_bwd
from mrfa_tpu_torch.ops.stream_probe import COLS, stream_probe
from mrfa_tpu_torch.tools.probe_lookup import (
    MAP_SIZE,
    N_CALLS,
    pooled_bwd_bytes,
    pooled_fwd_bytes,
    probe_inputs,
    timed_ms,
)
from mrfa_tpu_torch.utils.device import resolve_device

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
QB = 16  # queries per block of the TPU kernels' streaming


def run(bq: int = 4096, device=None, calls: int = N_CALLS, qb: int = QB) -> List[Dict]:
    device = resolve_device(device)
    h = w = MAP_SIZE
    sets = probe_inputs(bq, calls, device)
    levels = [(c.reshape(bq * h, w), F.avg_pool2d(c, 2).reshape(bq * h // 2, w // 2))
              for c, _, _ in sets]
    map_bytes = bq * h * w * 4
    out_bytes = 2 * bq * COLS * COLS * 4
    rows = []

    def report(label, ms, nbytes):
        rate = nbytes / (ms * 1e-3) if ms > 0 else float("inf")
        row = {"fn": label, "ms": ms, "bytes": nbytes, "gb_per_s": rate / 1e9,
               "share_of_3_35_tb_s": rate / HBM_BYTES_PER_S}
        print(f"bq={bq} qb={qb} {label:22s}: {ms:9.4f} ms  {nbytes / 1e6:8.2f} MB  "
              f"{rate / 1e9:8.1f} GB/s ({rate / HBM_BYTES_PER_S:.3f} of 3.35 TB/s)", flush=True)
        rows.append(row)

    report("avg_pool", timed_ms(lambda c, *_: F.avg_pool2d(c, 2), sets, device),
           map_bytes + map_bytes // 4)
    report("null stream l0+l1", timed_ms(lambda c0, c1: stream_probe(c0, c1, bq, qb),
                                         levels, device),
           map_bytes + map_bytes // 4 + out_bytes)
    report("null stream l0", timed_ms(lambda c0, _: stream_probe(c0, None, bq, qb),
                                      levels, device),
           map_bytes + out_bytes)
    corr, coords, _ = sets[0]
    report("pooled bwd kernel", timed_ms(corr_lookup_pooled_bwd, sets, device),
           pooled_bwd_bytes(coords, h, w, 4))
    report("pooled fwd", timed_ms(lambda c, x, _: corr_lookup_pooled(c, x), sets, device),
           pooled_fwd_bytes(bq, h, w, 4))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    parser.add_argument("--bq", type=int, default=4096)
    parser.add_argument("--calls", type=int, default=N_CALLS)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"probe_stream on {name}: maps {MAP_SIZE}x{MAP_SIZE} f32; each null stream "
          "rate is the streaming kernel's own, not the card's floor", flush=True)
    rows = run(args.bq, device, args.calls)
    print(json.dumps({"probe": "stream", "device": name, "bq": args.bq, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
