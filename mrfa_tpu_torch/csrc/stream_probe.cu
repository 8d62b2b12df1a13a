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
// (64 MiB + 16 MiB at bq = 4096, 64 x 64 maps); the output is 0.5 MiB.
//
// Design: each level is cut into tiles of 16 KiB of whole rows. A grid of a
// few blocks per SM walks the tiles of both levels; each block copies its
// next tile into shared memory with cp.async (16 B per thread and copy)
// while it writes out the rows of the current one that the mapping keeps,
// so there are two tiles in flight per block (double buffering). cp.async is
// an asm volatile instruction (LDGSTS in SASS), so the compiler keeps every
// load even though most of the streamed bytes are never read back.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // 16 KiB
constexpr int kCols = 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct LevelSpec {
  const float* src;
  int64_t floats;  // rows * width
  int width;       // floats per row (divides kTileFloats, multiple of 4)
  int64_t block_rows;  // qb * h rows per query block
  int64_t tiles;
};

struct Probe {
  LevelSpec lv[2];
  int nlevels;       // 2: c0 and c1; 1: c0 only, written to both outputs
  int64_t out_rows;  // bq * 8 rows per output level
  int n;             // 8 * qb rows kept per query block
};

__device__ __forceinline__ void tile_of(const Probe& p, int64_t k, int& l, int64_t& start,
                                        int& nfloats) {
  l = k < p.lv[0].tiles ? 0 : 1;
  const int64_t kk = l == 0 ? k : k - p.lv[0].tiles;
  start = kk * kTileFloats;
  const int64_t left = p.lv[l].floats - start;
  nfloats = static_cast<int>(left < kTileFloats ? left : kTileFloats);
}

__device__ __forceinline__ void prefetch(const Probe& p, int64_t k, float* buf) {
  int l, nfloats;
  int64_t start;
  tile_of(p, k, l, start, nfloats);
  const float* src = p.lv[l].src + start;
  for (int e = 4 * threadIdx.x; e < nfloats; e += 4 * kThreads) cp_async16(buf + e, src + e);
}

__global__ void __launch_bounds__(kThreads)
stream_probe_kernel(Probe p, float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][kTileFloats];
  const int64_t ntiles = p.lv[0].tiles + (p.nlevels == 2 ? p.lv[1].tiles : 0);
  int64_t k = blockIdx.x;
  int stage = 0;
  if (k < ntiles) prefetch(p, k, buf[0]);
  cp_async_commit();
  for (; k < ntiles; k += gridDim.x, stage ^= 1) {
    const int64_t next = k + gridDim.x;
    if (next < ntiles) prefetch(p, next, buf[stage ^ 1]);
    cp_async_commit();
    cp_async_wait_one();  // this tile's copies (all but the newest group) have landed
    __syncthreads();
    int l, nfloats;
    int64_t start;
    tile_of(p, k, l, start, nfloats);
    const LevelSpec& s = p.lv[l];
    const int rows = nfloats / s.width;
    const int64_t row0 = start / s.width;
    for (int e = threadIdx.x; e < rows * kCols; e += kThreads) {
      const int j = e / kCols;
      const int c = e - j * kCols;
      const int64_t row = row0 + j;
      const int64_t i = row / s.block_rows;
      const int64_t r = row - i * s.block_rows;
      if (r < p.n) {
        const float v = buf[stage][j * s.width + c];
        const int64_t o = (i * p.n + r) * kCols + c;
        out[l * p.out_rows * kCols + o] = v;
        if (p.nlevels == 1) out[p.out_rows * kCols + o] = v;
      }
    }
    __syncthreads();  // the buffer is refilled two iterations on
  }
}

LevelSpec level(const void* src, int64_t rows, int width, int64_t block_rows) {
  LevelSpec s;
  s.src = static_cast<const float*>(src);
  s.floats = rows * width;
  s.width = width;
  s.block_rows = block_rows;
  s.tiles = (s.floats + kTileFloats - 1) / kTileFloats;
  return s;
}

}  // namespace

// c0: (bq*h0, w0) f32; c1: (bq*h1, w1) f32, or null to stream c0 alone and
// write it to both output levels; out: (2, bq*8, 8) f32. All contiguous;
// bq % qb == 0, w0 and w1 multiples of 4 that divide 4096 and are >= 8,
// 8*qb <= qb*h1 (h1 >= 8). `blocks` is the grid size. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int mrfa_stream_probe(const void* c0, const void* c1, void* out, int64_t bq, int h0,
                                 int w0, int h1, int w1, int qb, int blocks, void* stream) {
  Probe p;
  p.lv[0] = level(c0, bq * h0, w0, static_cast<int64_t>(qb) * h0);
  p.nlevels = c1 ? 2 : 1;
  p.lv[1] = c1 ? level(c1, bq * h1, w1, static_cast<int64_t>(qb) * h1) : p.lv[0];
  p.out_rows = bq * kCols;
  p.n = kCols * qb;
  stream_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
