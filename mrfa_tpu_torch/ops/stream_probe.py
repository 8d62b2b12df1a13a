"""The streaming probe: every byte of the correlation levels through shared
memory, a fixed corner of each query block out.

`stream_probe(c0, c1, bq, qb)` replaces the two null kernels of
tools/probe_stream.py (`null_kernel`, `null0_kernel`) with one CUDA kernel,
`csrc/stream_probe.cu`. With c0 (BQ*h0, w0) and c1 (BQ*h1, w1) f32 (the
per-query maps and their 2x2 pool, rows stacked), n = 8 * qb, for query
block i, r < n and c < 8 the (2, BQ*8, 8) output holds
    out[0, i*n + r, c] = c0[i*qb*h0 + r, c]
    out[1, i*n + r, c] = c1[i*qb*h1 + r, c]   (c0 again when c1 is None).
The probe in mrfa_tpu_torch/tools/probe_stream.py prints the kernel's time
and rate. That rate is this kernel's own, not the card's streaming floor: it
reaches about half of the memory rate on an H100 (PERF.md), so a kernel that
keeps more bytes in flight (TMA bulk copies) would be needed before it can
bound the lookup kernels from below. On CUDA tensors the wrapper
launches the kernel (built at first use) or raises; on CPU tensors it runs
its plain PyTorch version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mrfa_tpu_torch.ops.cuda_build import CudaLibrary

COLS = 8
_TILE_FLOATS = 4096  # csrc/stream_probe.cu's tile
BLOCKS_PER_SM = 4


def _block_rows(level: torch.Tensor, bq: int, qb: int):
    """(query blocks, qb*h rows each, width) of one stacked level."""
    return bq // qb, (level.shape[0] // bq) * qb, level.shape[1]


def stream_probe_plain(c0: torch.Tensor, c1: Optional[torch.Tensor], bq: int,
                       qb: int = 16) -> torch.Tensor:
    """Plain PyTorch version: the strided corner of each block, copied."""
    n = COLS * qb
    outs = []
    for level in (c0, c0 if c1 is None else c1):
        nb, rows, w = _block_rows(level, bq, qb)
        outs.append(level.reshape(nb, rows, w)[:, :n, :COLS].reshape(nb * n, COLS))
    return torch.stack(outs)


def _check(c0: torch.Tensor, c1: Optional[torch.Tensor], bq: int, qb: int) -> None:
    levels = (c0,) if c1 is None else (c0, c1)
    if qb < 1 or bq < 1 or bq % qb:
        raise ValueError(f"bq ({bq}) must be a positive multiple of qb ({qb})")
    for level in levels:
        if level.dim() != 2 or level.shape[0] % bq:
            raise ValueError(f"want a (bq*h, w) level, got {tuple(level.shape)} for bq={bq}")
        h, w = level.shape[0] // bq, level.shape[1]
        if h < COLS or w < COLS or w % 4 or _TILE_FLOATS % w:
            raise ValueError(f"each level needs h >= 8 and a width >= 8 that divides "
                             f"{_TILE_FLOATS} in fours, got h={h}, w={w}")
        if level.dtype != torch.float32:
            raise TypeError(f"levels must be float32, got {level.dtype}")
        if level.device != c0.device or not level.is_contiguous():
            raise ValueError("levels must be contiguous and lie on one device")


class StreamProbe:
    """Callable wrapper around the streaming CUDA kernel, with its launch count."""

    name = "stream_probe"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary(
            "stream_probe.cu",
            {
                "mrfa_stream_probe": (
                    [ctypes.c_void_p] * 3
                    + [ctypes.c_int64] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                    ctypes.c_int,
                )
            },
        )

    def __call__(self, c0: torch.Tensor, c1: Optional[torch.Tensor], bq: int,
                 qb: int = 16) -> torch.Tensor:
        """c0 (BQ*h0, w0), c1 (BQ*h1, w1) or None -> (2, BQ*8, 8) f32."""
        _check(c0, c1, bq, qb)
        if c0.device.type == "cpu":
            return stream_probe_plain(c0, c1, bq, qb)
        if c0.device.type != "cuda":
            raise ValueError(f"stream_probe runs on cuda or cpu, not {c0.device}")
        out = torch.empty((2, bq * COLS, COLS), dtype=torch.float32, device=c0.device)
        h0, w0 = c0.shape[0] // bq, c0.shape[1]
        h1, w1 = (h0, w0) if c1 is None else (c1.shape[0] // bq, c1.shape[1])
        tiles = sum(-(-t.numel() // _TILE_FLOATS) for t in ((c0,) if c1 is None else (c0, c1)))
        sms = torch.cuda.get_device_properties(c0.device).multi_processor_count
        lib = self.library.load()
        with torch.cuda.device(c0.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mrfa_stream_probe(
                c0.data_ptr(), None if c1 is None else c1.data_ptr(), out.data_ptr(),
                bq, h0, w0, h1, w1, qb, min(tiles, BLOCKS_PER_SM * sms), stream,
            )
        if rc != 0:
            raise RuntimeError(f"stream_probe kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


stream_probe = StreamProbe()
