// Two-level 7x7 correlation window lookup of the refinement loop.
//
// Replaces the TPU kernels mrfa_tpu/ops/pallas_kernels.py::
// _corr_lookup_padded_kernel (serving, with _level_sample_padded; reached
// through corr_block_lookup_pallas_padded) and ::_corr_lookup_kernel (the
// training forward, with _level_sample_t; reached through
// corr_block_lookup_pallas_pret): the port's unpadded y-major maps are the
// latter's input with x and y swapped, so one kernel serves both. Semantics,
// per query q with centre (cx, cy) in level-0 pixels:
//   out[q, l*49 + i*7 + j] = bilinear sample of map_l[q] at
//                            (cx/2^l + i - 3, cy/2^l + j - 3),
// zeros outside the map; the x offset i runs along the FIRST window axis.
// Maps are y-major: map_l[q][y][x], level 0 (h, w), level 1 (h/2, w/2),
// f32 or bf16; the blend is f32 and the result is stored in the map dtype.
//
// What bounds it on an H100: bytes. A query reads at most two 8x8 integer
// patches (128 map values) at data-dependent addresses in its own maps and
// writes 98 values, for ~1100 flops. At BQ=40960 (training) the bytes take
// 0.0102 ms at 3.35 TB/s; at BQ=4096 (serving) 0.0010 ms, where the launch
// itself costs more.
//
// Design: one warp per query, eight queries to a 256-thread block. The warp
// stages both 8x8 patches into shared memory, zero-filled outside the map,
// with one load per value (four patch rows of eight values per load
// instruction, in the maps' dtype), and computes each level's fractions
// once. Each lane then blends at most four outputs from shared memory, with
// no bounds checks, and the 98 outputs of a query are stored as coalesced
// runs. The blend keeps the four terms, their order and their roundings
// (__fmul_rn / __fadd_rn, no FMA contraction) of the plain PyTorch version in
// ops/corr_lookup.py, so the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRadius = 3;
constexpr int kWin = 2 * kRadius + 1;  // 7
constexpr int kTaps = kWin * kWin;     // 49 per level
constexpr int kOut = 2 * kTaps;        // 98 per query
constexpr int kPatch = kWin + 1;       // 8: the integer patch a window reads
constexpr int kQueries = 8;            // queries (warps) per block
constexpr int kThreads = 32 * kQueries;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A level's window for one query: the clamped integer corner and the
// fractions of the unclamped centre.
struct Window {
  int x0, y0;
  float fx, fy, gx, gy;
};

__device__ __forceinline__ Window window(float cx, float cy, int h, int w) {
  Window r;
  const float x0f = floorf(cx);
  const float y0f = floorf(cy);
  r.fx = __fsub_rn(cx, x0f);
  r.fy = __fsub_rn(cy, y0f);
  r.gx = __fsub_rn(1.0f, r.fx);
  r.gy = __fsub_rn(1.0f, r.fy);
  // Clamp before the integer conversion: beyond this range every tap of the
  // window is out of bounds either way, so the result does not change.
  r.x0 = static_cast<int>(fminf(fmaxf(x0f, -(kRadius + 2.0f)), w + kRadius));
  r.y0 = static_cast<int>(fminf(fmaxf(y0f, -(kRadius + 2.0f)), h + kRadius));
  return r;
}

// The 8x8 patch [y][x] from (x0 - 3, y0 - 3) into shared memory, zeros
// outside the map: lane l loads row l / 8 (and 4 + l / 8), column l % 8.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ map, int h, int w, const Window& win,
                                      float* patch, int lane) {
  const int col = lane & (kPatch - 1);
  const int x = win.x0 - kRadius + col;
  const bool x_in = x >= 0 && x < w;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = (lane >> 3) + 4 * half;
    const int y = win.y0 - kRadius + row;
    patch[row * kPatch + col] = (x_in && y >= 0 && y < h) ? load_f32(map + y * w + x) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(const T* __restrict__ c0, const T* __restrict__ c1,
                   const float* __restrict__ coords, T* __restrict__ out, int64_t bq, int h0,
                   int w0) {
  __shared__ float patches[kQueries][2][kPatch * kPatch];
  const int lane = threadIdx.x & 31;
  const int wq = threadIdx.x >> 5;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kQueries + wq;
  if (q >= bq) return;  // whole warps only: no block-wide barrier follows

  const float cx = __ldg(coords + 2 * q);
  const float cy = __ldg(coords + 2 * q + 1);
  const int h1 = h0 >> 1;
  const int w1 = w0 >> 1;
  const Window win0 = window(cx, cy, h0, w0);
  const Window win1 = window(__fmul_rn(cx, 0.5f), __fmul_rn(cy, 0.5f), h1, w1);
  stage(c0 + q * h0 * w0, h0, w0, win0, patches[wq][0], lane);
  stage(c1 + q * h1 * w1, h1, w1, win1, patches[wq][1], lane);
  __syncwarp();

  T* dst = out + q * kOut;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = lane + 32 * k;
    if (c >= kOut) break;
    const int level = c >= kTaps;
    const int t = c - level * kTaps;
    const int i = t / kWin;  // x offset index
    const int j = t - i * kWin;  // y offset index
    const Window& win = level ? win1 : win0;
    const float* p = patches[wq][level] + j * kPatch + i;
    float v = __fmul_rn(__fmul_rn(win.gx, win.gy), p[0]);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(win.fx, win.gy), p[1]));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(win.gx, win.fy), p[kPatch]));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(win.fx, win.fy), p[kPatch + 1]));
    store_out(dst + c, v);
  }
}

template <typename T>
void launch(const void* c0, const void* c1, const void* coords, void* out,
            int64_t bq, int h0, int w0, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((bq + kQueries - 1) / kQueries);
  corr_lookup_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const float*>(coords), static_cast<T*>(out), bq, h0, w0);
}

}  // namespace

// c0: (bq, h0, w0), c1: (bq, h0/2, w0/2), both f32 (is_bf16 == 0) or bf16;
// coords: (bq, 2) f32 xy; out: (bq, 98) in the maps' dtype. All contiguous.
// bq >= 1. Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mrfa_corr_lookup(const void* c0, const void* c1, const void* coords,
                                void* out, int64_t bq, int h0, int w0, int is_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(c0, c1, coords, out, bq, h0, w0, s);
  } else {
    launch<float>(c0, c1, coords, out, bq, h0, w0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
