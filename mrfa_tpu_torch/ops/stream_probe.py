"""The streaming probe: every byte of the correlation levels through shared
memory, a fixed corner of each query block out.

`stream_probe(c0, c1, bq, qb)` replaces the two null kernels of
tools/probe_stream.py (`null_kernel`, `null0_kernel`) with one CUDA kernel,
`csrc/stream_probe.cu`. With c0 (BQ*h0, w0) and c1 (BQ*h1, w1) f32 (the
per-query maps and their 2x2 pool, rows stacked), n = 8 * qb, for query
block i, r < n and c < 8 the (2, BQ*8, 8) output holds
    out[0, i*n + r, c] = c0[i*qb*h0 + r, c]
    out[1, i*n + r, c] = c1[i*qb*h1 + r, c]   (c0 again when c1 is None).
The kernel streams each level in stages of whole rows with TMA bulk copies
into a ring of shared-memory slots, from a persistent grid (`launch_plan`
below is its plan, in Python). Its rate is what the card's memory system
gives a pure stream, the floor that the lookup kernels are held against
beside the data-sheet rate: on an H100 80GB HBM3 at a 700 W limit, 3.16
TB/s back to back over the 344 MB of BQ 16384 (94% of the data sheet's
3.35), 2.33 TB/s for one call at BQ 4096 after an L2 flush (PERF.md; from
`chip_smoke.py` and mrfa_tpu_torch/tools/stream_sweep.py). On CUDA tensors
the wrapper launches the kernel (built at first use) or raises; on CPU
tensors it runs its plain PyTorch version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mrfa_tpu_torch.ops.cuda_build import CudaLibrary

COLS = 8
SLOT_BYTES = 16384  # csrc/stream_probe.cu's kSlotBytes: one ring slot
BLOCKS_PER_SM = 2  # its kBlocksPerSm: the persistent grid
MAX_ROWS = 2 ** 31 - 1  # its 32-bit row index


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


class LevelPlan(NamedTuple):
    """One level's stages: runs of `stage_rows` whole rows, the last shorter
    when `stage_rows` does not divide `rows`."""

    rows: int
    row_bytes: int
    stage_rows: int
    stages: int

    @property
    def last_rows(self) -> int:
        return self.rows - (self.stages - 1) * self.stage_rows


class StreamPlan(NamedTuple):
    """The kernel's launch: the levels' stages, numbered in one order (level
    0's first), and a persistent grid of `blocks`, block b copying stages b,
    b + blocks, ... in turn."""

    levels: Tuple[LevelPlan, ...]
    blocks: int

    @property
    def stages(self) -> int:
        return sum(lv.stages for lv in self.levels)

    def stage(self, k: int) -> Tuple[int, int, int, int]:
        """(level, first row, rows, bytes) of stage k, as the kernel's `stage_of`."""
        level = 0 if k < self.levels[0].stages else 1
        lv = self.levels[level]
        row0 = (k - level * self.levels[0].stages) * lv.stage_rows
        rows = min(lv.stage_rows, lv.rows - row0)
        return level, row0, rows, rows * lv.row_bytes


def launch_plan(shapes: Sequence[Tuple[int, int]], sms: int) -> StreamPlan:
    """The plan for levels of (rows, width) f32 on a card of `sms` SMs.
    Raises for a width the ring cannot take in whole 16-byte rows and for a
    level of 2^31 rows or more (the kernel indexes rows in 32 bits)."""
    levels = []
    for rows, w in shapes:
        if not 1 <= rows <= MAX_ROWS:
            raise ValueError(f"a level needs 1 to 2^31 - 1 rows, got {rows}")
        if w < COLS or w % 4 or 4 * w > SLOT_BYTES:
            raise ValueError(f"each level needs a width >= 8, a multiple of 4 and at most "
                             f"{SLOT_BYTES // 4}, got {w}")
        stage_rows = SLOT_BYTES // (4 * w)
        levels.append(LevelPlan(rows, 4 * w, stage_rows, -(-rows // stage_rows)))
    plan = StreamPlan(tuple(levels), 1)
    return plan._replace(blocks=min(plan.stages, BLOCKS_PER_SM * sms))


def _check(c0: torch.Tensor, c1: Optional[torch.Tensor], bq: int, qb: int,
           sms: int = 1) -> StreamPlan:
    levels = (c0,) if c1 is None else (c0, c1)
    if qb < 1 or bq < 1 or bq % qb:
        raise ValueError(f"bq ({bq}) must be a positive multiple of qb ({qb})")
    for level in levels:
        if level.dim() != 2 or level.shape[0] % bq:
            raise ValueError(f"want a (bq*h, w) level, got {tuple(level.shape)} for bq={bq}")
        if level.shape[0] // bq < COLS:
            raise ValueError(f"each level needs h >= 8, got h={level.shape[0] // bq}")
        if level.dtype != torch.float32:
            raise TypeError(f"levels must be float32, got {level.dtype}")
        if level.device != c0.device or not level.is_contiguous():
            raise ValueError("levels must be contiguous and lie on one device")
    return launch_plan([tuple(level.shape) for level in levels], sms)


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
        if c0.device.type == "cpu":
            _check(c0, c1, bq, qb)
            return stream_probe_plain(c0, c1, bq, qb)
        if c0.device.type != "cuda":
            raise ValueError(f"stream_probe runs on cuda or cpu, not {c0.device}")
        sms = torch.cuda.get_device_properties(c0.device).multi_processor_count
        plan = _check(c0, c1, bq, qb, sms)
        if any(t.data_ptr() % 16 for t in ((c0,) if c1 is None else (c0, c1))):
            raise ValueError("stream_probe's bulk copies need 16-byte aligned levels "
                             "(a view at an offset is not; pass a fresh tensor)")
        out = torch.empty((2, bq * COLS, COLS), dtype=torch.float32, device=c0.device)
        h0, w0 = c0.shape[0] // bq, c0.shape[1]
        h1, w1 = (h0, w0) if c1 is None else (c1.shape[0] // bq, c1.shape[1])
        lib = self.library.load()
        with torch.cuda.device(c0.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.mrfa_stream_probe(
                c0.data_ptr(), None if c1 is None else c1.data_ptr(), out.data_ptr(),
                bq, h0, w0, h1, w1, qb, plan.blocks, stream,
            )
        if rc != 0:
            raise RuntimeError(f"stream_probe kernel launch failed: CUDA error {rc}")
        self.launches += 1
        return out


stream_probe = StreamProbe()
