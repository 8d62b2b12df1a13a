"""Sweeps the streaming probe kernel's ring on the card.

    python mrfa_tpu_torch/tools/stream_sweep.py [--rounds 2]

Each variant of `csrc/stream_probe.cu` sets its slot bytes (`kSlotBytes`),
ring slots (`kRing`) and blocks an SM (`kBlocksPerSm`), with or without the
L2 evict-first policy on its bulk copies. It is built from a patched copy
under `build/stream_sweep/`, checked bit for bit against
`stream_probe_plain` in both variants, and timed on both levels of 64x64
f32 maps at BQ 4096 and 16384: after the 256 MB zeroing flush of
`kernel_times.cuda_ms`, after a flush that reads 256 MB (which leaves the
L2 clean, so that no write-back of dirty lines falls into the kernel's
time), and back to back. The same-bytes library read (`l0.sum();
l1.sum()`) is timed the same three ways. The variants run in turns, forward
then backward, `--rounds` passes in all. One JSON line per variant and
pass; the script needs a CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# (slot bytes, ring slots, blocks an SM, evict-first policy)
VARIANTS = ((16384, 4, 2, True), (16384, 6, 2, True), (32768, 4, 1, True), (24576, 4, 2, True),
            (32768, 3, 2, True), (16384, 12, 1, True), (8192, 12, 2, True),
            (16384, 4, 2, False), (16384, 6, 2, False), (32768, 6, 1, False))
POLICY = re.compile(r'  uint64_t policy;\n  asm volatile\("createpolicy[^\n]*\n')


def variant_source(source: str, slot: int, ring: int, per_sm: int, evict_first: bool) -> str:
    """The kernel's source with these ring constants, and without the L2
    policy unless `evict_first`."""
    out = source
    for name, value in (("kSlotBytes", slot), ("kRing", ring), ("kBlocksPerSm", per_sm)):
        out, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", out)
        assert n == 1, name
    if not evict_first:
        out, n = POLICY.subn("", out)
        assert n == 1
        out = out.replace(".L2::cache_hint", "").replace(', [%3], %4;', ', [%3];')
        out = out.replace(', "l"(policy)', "")
    return out


def build(source: str, name: str) -> ctypes.CDLL:
    from mrfa_tpu_torch.ops.cuda_build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    out_dir = BUILD_DIR / "stream_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    if not so.exists():
        cu.write_text(source)
        r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.mrfa_stream_probe.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                                      + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.mrfa_stream_probe.restype = ctypes.c_int
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("stream_sweep: no CUDA device", file=sys.stderr)
        return 2
    from mrfa_tpu_torch.ops.cuda_build import CSRC_DIR
    from mrfa_tpu_torch.ops.stream_probe import COLS, stream_probe_plain
    from mrfa_tpu_torch.tools.kernel_times import (
        back_to_back_ms,
        cuda_ms,
        make_flush,
        make_read_flush,
        stream_bytes,
        stream_levels,
        stream_same_bytes,
    )

    device = torch.device("cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    flushes = {"zero_flush": make_flush(device), "read_flush": make_read_flush(device)}
    levels = {bq: stream_levels(bq, device, seed=13) for bq in (4096, 16384)}
    source = (CSRC_DIR / "stream_probe.cu").read_text()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "sms": sms}), flush=True)

    def timings(fn):
        times = {f"ms_{k}": cuda_ms(fn, 20, f) for k, f in flushes.items()}
        times["ms_back_to_back"] = back_to_back_ms(fn, 20)
        return times

    order = [v for r in range(args.rounds) for v in (VARIANTS if r % 2 == 0 else VARIANTS[::-1])]
    for slot, ring, per_sm, evict_first in order:
        name = f"slot{slot}_ring{ring}_sm{per_sm}_{'evict_first' if evict_first else 'normal'}"
        lib = build(variant_source(source, slot, ring, per_sm, evict_first), name)
        row = {"variant": name}
        for bq, (l0, l1) in levels.items():
            stages = sum(-(-lv.shape[0] // (slot // (4 * lv.shape[1]))) for lv in (l0, l1))

            def call(c1=l1, bq=bq, l0=l0, blocks=min(stages, per_sm * sms)):
                out = torch.empty(2, bq * COLS, COLS, device=device)
                rc = lib.mrfa_stream_probe(
                    l0.data_ptr(), None if c1 is None else c1.data_ptr(), out.data_ptr(), bq,
                    l0.shape[0] // bq, l0.shape[1], l1.shape[0] // bq, l1.shape[1], 16, blocks,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
                return out

            exact = all(torch.equal(call(c1), stream_probe_plain(l0, c1, bq, 16))
                        for c1 in (l1, None))
            row[str(bq)] = {"bit_exact": exact, **timings(call),
                            "bytes": stream_bytes(bq, (l0, l1))}
        print(json.dumps(row), flush=True)
        if not all(row[str(bq)]["bit_exact"] for bq in levels):
            return 1
    for bq, (l0, l1) in levels.items():
        print(json.dumps({"library_same_bytes": bq,
                          **timings(lambda: stream_same_bytes(l0, l1))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
