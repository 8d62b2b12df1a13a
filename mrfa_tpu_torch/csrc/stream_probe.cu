// Streaming probe: reads both correlation levels through shared memory and
// writes a fixed n x 8 corner of each query block.
//
// Replaces the two null kernels of tools/probe_stream.py (null_kernel and
// null0_kernel), which stream the patch-extract kernel's map blocks through
// VMEM with trivial compute, so that their time is the pipeline's streaming
// floor. With qb queries per block and n = 8 * qb, for block i, r < n, c < 8:
//   out[0][i*n + r][c] = c0[i*qb*h0 + r][c]
//   out[1][i*n + r][c] = c1[i*qb*h1 + r][c]   (c0[i*qb*h0 + r][c] without c1)
// where c0 is (bq*h0, w0) and c1 is (bq*h1, w1), both f32.
//
// What bounds it on an H100: bytes. Every byte of both inputs is read once
// (64 MiB + 16 MiB at bq = 4096, 64 x 64 maps); the output is 2 MiB.
//
// Design: each level is cut into stages of whole rows, at most one 16 KiB
// ring slot each (the last stage of a level may be shorter). A persistent
// grid of two blocks per SM walks the stages of both levels in a fixed order
// (block b takes stages b, b + grid, ...). In each block one producer thread
// keeps a ring of four slots filled with one 1-D TMA bulk copy per stage
// (cp.async.bulk ... mbarrier::complete_tx::bytes, after an arrive.expect_tx
// of the stage's bytes on the slot's full barrier), so that up to 64 KiB a
// block, 128 KiB an SM, are in flight with no per-thread load instructions.
// Each copy carries an L2 evict-first policy: the stream is read once, so
// its lines go before anything else the L2 holds. (A sweep of slots of 8-32
// KiB, rings of 3-12 slots and 1-3 blocks an SM moved the time by under 6%;
// the policy took 2-12% off; PERF.md, H100 80GB HBM3 at 700 W,
// mrfa_tpu_torch/tools/stream_sweep.py.)
// Four consumer warps wait on a slot's full barrier, copy the stage's kept
// corner rows out (two 16-byte stores a row), and arrive on its empty
// barrier; the producer refills the slot only after that barrier's phase
// flips. The consumers' index arithmetic is 32-bit: one division per stage
// finds its first query block, and rows are below 2^31 (the wrapper checks
// it). A bulk copy lands every byte in shared memory whether or not it is
// read back, so the probe streams every byte of both levels. Every barrier
// wait gives up with __trap() after ~2 s of clock cycles, so a wrong byte
// count ends the launch with an error instead of hanging the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = 32 + kConsumers;  // warp 0: the producer
constexpr int kSlotBytes = 16384;
constexpr int kRing = 4;
constexpr int kSmemBytes = kRing * kSlotBytes;
constexpr int kBlocksPerSm = 2;
constexpr int kCols = 8;
constexpr long long kSpinCycles = 4000000000LL;  // ~2 s at the H100's boost clock

struct Level {
  const char* src;
  float* out;       // this level's (bq*8, 8) output
  float* out_copy;  // the other output level when c0 is written to both, else null
  int rows;         // < 2^31
  int row_bytes;    // 4 * width, a multiple of 16
  int stage_rows;   // kSlotBytes / row_bytes
  int stages;
  int block_rows;   // qb * h rows per query block
};

struct Probe {
  Level lv[2];
  int stages;  // of both levels
  int n;       // 8 * qb rows kept per query block
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity has completed; traps after
// kSpinCycles, far beyond any copy of a 16 KiB stage.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kSpinCycles) __trap();
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on `bar`, its lines marked
// evict-first in the L2.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Stage k of the walk: its level, its first row and its row count.
__device__ __forceinline__ Level stage_of(const Probe& p, int k, int& row0, int& rows) {
  const bool second = k >= p.lv[0].stages;
  const Level lv = second ? p.lv[1] : p.lv[0];
  row0 = (second ? k - p.lv[0].stages : k) * lv.stage_rows;
  rows = min(lv.stage_rows, lv.rows - row0);
  return lv;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stream_probe_kernel(const __grid_constant__ Probe p) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kRing];
  __shared__ __align__(8) uint64_t empty[kRing];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int k = blockIdx.x; k < p.stages; k += gridDim.x) {
        int row0, rows;
        const Level lv = stage_of(p, k, row0, rows);
        const uint32_t bytes = static_cast<uint32_t>(rows * lv.row_bytes);
        mbar_wait(&empty[slot], phase ^ 1);  // a fresh barrier passes its first wait
        mbar_expect_tx(&full[slot], bytes);
        bulk_load(ring + slot * kSlotBytes,
                  lv.src + static_cast<int64_t>(row0) * lv.row_bytes, bytes, &full[slot]);
        if (++slot == kRing) slot = 0, phase ^= 1;
      }
    }
    return;
  }

  const int t = threadIdx.x - 32;
  int slot = 0;
  uint32_t phase = 0;
  for (int k = blockIdx.x; k < p.stages; k += gridDim.x) {
    int row0, rows;
    const Level lv = stage_of(p, k, row0, rows);
    mbar_wait(&full[slot], phase);
    const float4* tile = reinterpret_cast<const float4*>(ring + slot * kSlotBytes);
    const int row_vecs = lv.row_bytes / 16;
    int blk = row0 / lv.block_rows;  // the stage's first query block
    int rel = row0 - blk * lv.block_rows;
    for (int j = 0;;) {
      // rows j .. j + keep - 1 of the stage are rows rel .. of block blk, kept
      const int keep = min(max(p.n - rel, 0), rows - j);
      if (keep > 0) {
        const int64_t o = static_cast<int64_t>(blk * p.n + rel) * kCols;
        float4* dst = reinterpret_cast<float4*>(lv.out + o);
        float4* dst2 = lv.out_copy ? reinterpret_cast<float4*>(lv.out_copy + o) : nullptr;
        for (int e = t; e < 2 * keep; e += kConsumers) {
          const float4 v = tile[(j + (e >> 1)) * row_vecs + (e & 1)];
          dst[e] = v;
          if (dst2) dst2[e] = v;
        }
      }
      const int to_next = lv.block_rows - rel;  // rows to the next block's first
      if (to_next >= rows - j) break;
      j += to_next;
      rel = 0;
      ++blk;
    }
    mbar_arrive(&empty[slot]);
    if (++slot == kRing) slot = 0, phase ^= 1;
  }
}

Level level(const void* src, float* out, int64_t rows, int width, int64_t block_rows) {
  Level lv;
  lv.src = static_cast<const char*>(src);
  lv.out = out;
  lv.out_copy = nullptr;
  lv.rows = static_cast<int>(rows);
  lv.row_bytes = 4 * width;
  lv.stage_rows = kSlotBytes / lv.row_bytes;
  lv.stages = static_cast<int>((rows + lv.stage_rows - 1) / lv.stage_rows);
  lv.block_rows = static_cast<int>(block_rows);
  return lv;
}

}  // namespace

// c0: (bq*h0, w0) f32; c1: (bq*h1, w1) f32, or null to stream c0 alone and
// write it to both output levels; out: (2, bq*8, 8) f32. All contiguous and
// 16-byte aligned; bq % qb == 0, w0 and w1 multiples of 4 in [8, 4096],
// h0 and h1 >= 8, bq*h0 and bq*h1 below 2^31. `blocks` is the grid size
// (the wrapper gives min(stages, 2 * SMs)). Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments
// outside that range.
extern "C" int mrfa_stream_probe(const void* c0, const void* c1, void* out, int64_t bq, int h0,
                                 int w0, int h1, int w1, int qb, int blocks, void* stream) {
  const int64_t limit = int64_t{1} << 31;
  const bool aligned = reinterpret_cast<uintptr_t>(c0) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(c1) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int wmax = kSlotBytes / 4;
  if (!aligned || bq * h0 >= limit || bq * h1 >= limit || w0 % 4 || w1 % 4 || w0 < kCols ||
      w1 < kCols || w0 > wmax || w1 > wmax || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the ring lies beyond the 48 KiB a block gets without asking
  const cudaError_t err = cudaFuncSetAttribute(
      stream_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* o = static_cast<float*>(out);
  float* o1 = o + bq * kCols * kCols;
  Probe p;
  p.lv[0] = level(c0, o, bq * h0, w0, static_cast<int64_t>(qb) * h0);
  if (c1) {
    p.lv[1] = level(c1, o1, bq * h1, w1, static_cast<int64_t>(qb) * h1);
  } else {
    p.lv[0].out_copy = o1;
    p.lv[1] = p.lv[0];
    p.lv[1].stages = 0;
  }
  p.stages = p.lv[0].stages + p.lv[1].stages;
  p.n = kCols * qb;
  stream_probe_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
