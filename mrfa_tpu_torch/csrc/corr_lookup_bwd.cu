// Backward of the two-level 7x7 correlation window lookup (training).
//
// Replaces the two TPU kernels of the lookup's VJP in
// mrfa_tpu/ops/pallas_kernels.py, reached through
// _corr_lookup_pallas_pret_bwd_impl (the backward of
// corr_block_lookup_pallas_pret, the training lookup):
//   _patch_extract_kernel: each query's raw 8x8 patch per level, zeros
//     outside the map (it feeds the coordinate gradient);
//   _patch_scatter_kernel: each query's 8x8 cotangent patch written into its
//     own zeroed d_map.
// Here one kernel does both. Per query q with centre (cx, cy) and level l
// (centre (cx, cy) / 2^l, x0 = floor, fx = fraction, corners clamped as in
// the forward kernel), with P[a][b] = map_l[q][y0 - 3 + b][x0 - 3 + a] (zero
// outside the map) and G[i][j] = g[q, l*49 + i*7 + j]:
//   d8[a][b]  = w00 G[a][b] + wx G[a-1][b] + wy G[a][b-1] + w11 G[a-1][b-1]
//               (G zero outside 0..6; w00 = (1-fx)(1-fy), wx = fx(1-fy),
//               wy = (1-fx)fy, w11 = fx fy), summed in f32 and cast once;
//   d_map_l[q] = d8 placed at the patch, exact zeros everywhere else;
//   dcx_l = sum G (gy (P[i+1][j] - P[i][j]) + fy (P[i+1][j+1] - P[i][j+1])),
//   dcy_l = sum G (gx (P[i][j+1] - P[i][j]) + fx (P[i+1][j+1] - P[i+1][j])),
//   d_coords[q] = (dcx_0 + dcx_1 / 2, dcy_0 + dcy_1 / 2)  (f32).
// Maps are y-major (map[y][x]), f32 or bf16; the JAX kernels work on x-major
// maps, which only swaps the roles of the two axes.
//
// What bounds it on an H100: bytes. Each query owns its two maps, so the
// kernel writes all of them, (64*64 + 32*32) values per query at the training
// step's sizes (839 MB in f32 at BQ = 40960), against 128 map values and 98
// gradients read; the arithmetic is a few hundred flops per query.
//
// Design (first, simple version): one block of 128 threads per query. The
// block stages g, both 8x8 patches and both cotangent patches in shared
// memory, one thread sums the coordinate gradient in a fixed order, and then
// all threads write the two d_maps front to back, four consecutive values
// per thread and store (16 B in f32, 8 B in bf16), so the stores are
// coalesced and the maps need no separate memset. Each query owns its maps:
// plain stores, no atomics. Products and sums are rounded as in the plain
// version (`__fmul_rn`/`__fadd_rn`, no FMA contraction), so the d_maps agree
// with it bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRadius = 3;
constexpr int kWin = 2 * kRadius + 1;  // 7
constexpr int kPatch = kWin + 1;       // 8
constexpr int kTaps = kWin * kWin;     // 49 per level
constexpr int kOut = 2 * kTaps;        // 98 per query
constexpr int kThreads = 128;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);  // .x (first element) = a
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

struct Level {
  int x0, y0;  // clamped integer corner of the window's first tap + 3
  float fx, fy, gx, gy;
};

// The same centre arithmetic as the forward kernel (csrc/corr_lookup.cu).
__device__ __forceinline__ Level level_geometry(float cx, float cy, int level, int h, int w) {
  if (level == 1) {
    cx = __fmul_rn(cx, 0.5f);
    cy = __fmul_rn(cy, 0.5f);
  }
  const float x0f = floorf(cx);
  const float y0f = floorf(cy);
  Level g;
  g.fx = __fsub_rn(cx, x0f);
  g.fy = __fsub_rn(cy, y0f);
  g.gx = __fsub_rn(1.0f, g.fx);
  g.gy = __fsub_rn(1.0f, g.fy);
  g.x0 = static_cast<int>(fminf(fmaxf(x0f, -(kRadius + 2.0f)), w + kRadius));
  g.y0 = static_cast<int>(fminf(fmaxf(y0f, -(kRadius + 2.0f)), h + kRadius));
  return g;
}

// Writes one query's whole d_map (h*w values): d8 on the patch, zeros elsewhere.
template <typename T>
__device__ __forceinline__ void write_map(T* dmap, const float (*d8)[kPatch], int h, int w,
                                          int xs, int ys) {
  auto value = [&](int y, int x) {
    const int a = x - xs;
    const int b = y - ys;
    return (static_cast<unsigned>(a) < kPatch && static_cast<unsigned>(b) < kPatch) ? d8[a][b]
                                                                                    : 0.0f;
  };
  const int hw = h * w;
  if (w % 4 == 0) {  // four values of one row per store; hw % 4 == 0 keeps it aligned
    for (int e = 4 * threadIdx.x; e < hw; e += 4 * kThreads) {
      const int y = e / w;
      const int x = e - y * w;
      store4(dmap + e, value(y, x), value(y, x + 1), value(y, x + 2), value(y, x + 3));
    }
  } else {
    for (int e = threadIdx.x; e < hw; e += kThreads) {
      const int y = e / w;
      store1(dmap + e, value(y, e - y * w));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_bwd_kernel(const T* __restrict__ c0, const T* __restrict__ c1,
                       const float* __restrict__ coords, const float* __restrict__ g,
                       T* __restrict__ d0, T* __restrict__ d1, float* __restrict__ dcoords,
                       int h0, int w0) {
  __shared__ float sg[kOut];
  __shared__ float sp[2][kPatch][kPatch];  // [level][x tap a][y tap b]
  __shared__ float sd[2][kPatch][kPatch];
  __shared__ float sdx[kOut];
  __shared__ float sdy[kOut];

  const int64_t q = blockIdx.x;
  const int t = threadIdx.x;
  const float cx = __ldg(coords + 2 * q);
  const float cy = __ldg(coords + 2 * q + 1);
  const int h1 = h0 >> 1;
  const int w1 = w0 >> 1;
  const Level lv[2] = {level_geometry(cx, cy, 0, h0, w0), level_geometry(cx, cy, 1, h1, w1)};

  if (t < kOut) sg[t] = __ldg(g + q * kOut + t);
  {  // 2 x 64 patch values, one per thread
    const int l = t >> 6;
    const int a = (t >> 3) & 7;
    const int b = t & 7;
    const int h = l ? h1 : h0;
    const int w = l ? w1 : w0;
    const T* map = l ? c1 + q * h1 * w1 : c0 + q * h0 * w0;
    const int x = lv[l].x0 - kRadius + a;
    const int y = lv[l].y0 - kRadius + b;
    sp[l][a][b] = (x >= 0 && x < w && y >= 0 && y < h) ? load_f32(map + y * w + x) : 0.0f;
  }
  __syncthreads();

  {  // cotangent patches, one value per thread
    const int l = t >> 6;
    const int a = (t >> 3) & 7;
    const int b = t & 7;
    const Level& v = lv[l];
    const float* G = sg + l * kTaps;
    auto gat = [&](int i, int j) {
      return (static_cast<unsigned>(i) < kWin && static_cast<unsigned>(j) < kWin) ? G[i * kWin + j]
                                                                                  : 0.0f;
    };
    float d = __fmul_rn(__fmul_rn(v.gx, v.gy), gat(a, b));
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(v.fx, v.gy), gat(a - 1, b)));
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(v.gx, v.fy), gat(a, b - 1)));
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(v.fx, v.fy), gat(a - 1, b - 1)));
    sd[l][a][b] = d;
  }
  if (t < kOut) {  // coordinate-gradient terms
    const int l = t / kTaps;
    const int i = (t - l * kTaps) / kWin;
    const int j = t - l * kTaps - i * kWin;
    const Level& v = lv[l];
    const float (*P)[kPatch] = sp[l];
    const float ddx = __fadd_rn(__fmul_rn(v.gy, __fsub_rn(P[i + 1][j], P[i][j])),
                                __fmul_rn(v.fy, __fsub_rn(P[i + 1][j + 1], P[i][j + 1])));
    const float ddy = __fadd_rn(__fmul_rn(v.gx, __fsub_rn(P[i][j + 1], P[i][j])),
                                __fmul_rn(v.fx, __fsub_rn(P[i + 1][j + 1], P[i + 1][j])));
    sdx[t] = __fmul_rn(sg[t], ddx);
    sdy[t] = __fmul_rn(sg[t], ddy);
  }
  __syncthreads();

  if (t == 0) {
    float sx[2] = {0.0f, 0.0f};
    float sy[2] = {0.0f, 0.0f};
    for (int l = 0; l < 2; ++l) {
      for (int k = 0; k < kTaps; ++k) {
        sx[l] = __fadd_rn(sx[l], sdx[l * kTaps + k]);
        sy[l] = __fadd_rn(sy[l], sdy[l * kTaps + k]);
      }
    }
    dcoords[2 * q] = __fadd_rn(sx[0], __fmul_rn(0.5f, sx[1]));
    dcoords[2 * q + 1] = __fadd_rn(sy[0], __fmul_rn(0.5f, sy[1]));
  }
  write_map(d0 + q * h0 * w0, sd[0], h0, w0, lv[0].x0 - kRadius, lv[0].y0 - kRadius);
  write_map(d1 + q * h1 * w1, sd[1], h1, w1, lv[1].x0 - kRadius, lv[1].y0 - kRadius);
}

template <typename T>
void launch(const void* c0, const void* c1, const void* coords, const void* g, void* d0,
            void* d1, void* dcoords, int64_t bq, int h0, int w0, cudaStream_t stream) {
  corr_lookup_bwd_kernel<T><<<static_cast<unsigned>(bq), kThreads, 0, stream>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1), static_cast<const float*>(coords),
      static_cast<const float*>(g), static_cast<T*>(d0), static_cast<T*>(d1),
      static_cast<float*>(dcoords), h0, w0);
}

}  // namespace

// c0: (bq, h0, w0), c1: (bq, h0/2, w0/2), both f32 (is_bf16 == 0) or bf16;
// coords: (bq, 2) f32 xy; g: (bq, 98) f32; d0, d1: like c0, c1 (every value
// written); dcoords: (bq, 2) f32. All contiguous; bq >= 1, h0 and w0 even.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mrfa_corr_lookup_bwd(const void* c0, const void* c1, const void* coords,
                                    const void* g, void* d0, void* d1, void* dcoords,
                                    int64_t bq, int h0, int w0, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(c0, c1, coords, g, d0, d1, dcoords, bq, h0, w0, s);
  } else {
    launch<float>(c0, c1, coords, g, d0, d1, dcoords, bq, h0, w0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
