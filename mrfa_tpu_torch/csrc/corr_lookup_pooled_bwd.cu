// Backward of the pooled two-level 7x7 correlation window lookup.
//
// Replaces the TPU kernel mrfa_tpu/ops/pallas_kernels.py::_corr_lookup_bwd_kernel
// (launched by _corr_lookup_pallas_bwd_impl, the first backward of
// corr_block_lookup_pallas), fold through the 2x2 average pool included.
// Per query q with map M = corr[q] (h x w, y-major), centre (cx, cy) and
// level l (level 0 is M, level 1 its 2x2 mean P[Y][X] = (((M[2Y][2X] +
// M[2Y][2X+1]) + M[2Y+1][2X]) + M[2Y+1][2X+1]) / 4; centre (cx, cy) / 2^l,
// x0 = floor, fx = fraction, corners clamped as in the forward kernel), with
// the raw 8x8 patch L_l[a][b] = level_l[y0 - 3 + b][x0 - 3 + a] (zero outside
// the level) and G[i][j] = g[q, l*49 + i*7 + j]:
//   d8_l[a][b] = w00 G[a][b] + wx G[a-1][b] + wy G[a][b-1] + w11 G[a-1][b-1]
//                (G zero outside 0..6), summed in f32;
//   d_corr[q][y][x] = D0[y][x] + D1[y/2][x/2] * 0.25, where D_l is d8_l placed
//                at its patch and zero elsewhere (level-1 taps fold through
//                the pool's transpose), rounded once to corr's dtype;
//   dcx_l, dcy_l = the a.e. derivatives of the blend against G (as in
//                csrc/corr_lookup_bwd.cu), and
//   d_coords[q] = (dcx_0 + dcx_1 / 2, dcy_0 + dcy_1 / 2)  (f32).
//
// What bounds it on an H100: bytes. Each query owns its map, so the kernel
// writes all of it (64 * 64 values per query at the probes' sizes: 268 MB in
// f32 at BQ = 16384), against at most a 16 x 16 region of the map and 98
// gradients read per query; the arithmetic is a few hundred flops per query.
//
// Design (first, simple version): one block of 128 threads per query. There
// is no pooled map in device memory: the level-1 patch is formed on the fly
// as 2x2 means of the level-0 values beneath it, in the sum order of
// F.avg_pool2d's CUDA kernel, so it matches the plain version's pool. The
// block stages g, both 8x8 patches and both cotangent patches in shared
// memory, one thread sums the coordinate gradient in a fixed order, and all
// threads then write the query's whole d_corr front to back, four consecutive
// values per thread and store (16 B in f32, 8 B in bf16), zeros included:
// no memset, no atomics (each query owns its map). Products and sums are
// rounded as in the plain version (`__fmul_rn`/`__fadd_rn`, no FMA
// contraction), so d_corr agrees with it bit for bit.

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

// d8_l at level-l position (x, y) of a patch starting at (xs, ys); zero off the patch.
__device__ __forceinline__ float patch_at(const float (*d8)[kPatch], int x, int y, int xs,
                                          int ys) {
  const int a = x - xs;
  const int b = y - ys;
  return (static_cast<unsigned>(a) < kPatch && static_cast<unsigned>(b) < kPatch) ? d8[a][b]
                                                                                  : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_pooled_bwd_kernel(const T* __restrict__ corr, const float* __restrict__ coords,
                              const float* __restrict__ g, T* __restrict__ dcorr,
                              float* __restrict__ dcoords, int h0, int w0) {
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
  const T* map = corr + q * h0 * w0;

  if (t < kOut) sg[t] = __ldg(g + q * kOut + t);
  {  // 2 x 64 patch values, one per thread; level 1 pooled from level 0 here
    const int l = t >> 6;
    const int a = (t >> 3) & 7;
    const int b = t & 7;
    const int x = lv[l].x0 - kRadius + a;
    const int y = lv[l].y0 - kRadius + b;
    float v = 0.0f;
    if (l == 0) {
      if (x >= 0 && x < w0 && y >= 0 && y < h0) v = load_f32(map + y * w0 + x);
    } else if (x >= 0 && x < w1 && y >= 0 && y < h1) {
      const T* p = map + (2 * y) * w0 + 2 * x;
      v = __fadd_rn(__fadd_rn(__fadd_rn(load_f32(p), load_f32(p + 1)), load_f32(p + w0)),
                    load_f32(p + w0 + 1));
      v = __fdiv_rn(v, 4.0f);
    }
    sp[l][a][b] = v;
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

  // the whole map: D0 + D1 / 4 at every value, zeros included
  const int xs0 = lv[0].x0 - kRadius, ys0 = lv[0].y0 - kRadius;
  const int xs1 = lv[1].x0 - kRadius, ys1 = lv[1].y0 - kRadius;
  auto value = [&](int y, int x) {
    return __fadd_rn(patch_at(sd[0], x, y, xs0, ys0),
                     __fmul_rn(patch_at(sd[1], x >> 1, y >> 1, xs1, ys1), 0.25f));
  };
  T* out = dcorr + q * h0 * w0;
  const int hw = h0 * w0;
  if (w0 % 4 == 0) {  // four values of one row per store; hw % 4 == 0 keeps it aligned
    for (int e = 4 * t; e < hw; e += 4 * kThreads) {
      const int y = e / w0;
      const int x = e - y * w0;
      store4(out + e, value(y, x), value(y, x + 1), value(y, x + 2), value(y, x + 3));
    }
  } else {
    for (int e = t; e < hw; e += kThreads) {
      const int y = e / w0;
      store1(out + e, value(y, e - y * w0));
    }
  }
}

template <typename T>
void launch(const void* corr, const void* coords, const void* g, void* dcorr, void* dcoords,
            int64_t bq, int h0, int w0, cudaStream_t stream) {
  corr_lookup_pooled_bwd_kernel<T><<<static_cast<unsigned>(bq), kThreads, 0, stream>>>(
      static_cast<const T*>(corr), static_cast<const float*>(coords),
      static_cast<const float*>(g), static_cast<T*>(dcorr), static_cast<float*>(dcoords), h0,
      w0);
}

}  // namespace

// corr: (bq, h0, w0), f32 (is_bf16 == 0) or bf16; coords: (bq, 2) f32 xy;
// g: (bq, 98) f32; dcorr: like corr (every value written); dcoords: (bq, 2)
// f32. All contiguous; bq >= 1, h0 and w0 even. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int mrfa_corr_lookup_pooled_bwd(const void* corr, const void* coords, const void* g,
                                           void* dcorr, void* dcoords, int64_t bq, int h0,
                                           int w0, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(corr, coords, g, dcorr, dcoords, bq, h0, w0, s);
  } else {
    launch<float>(corr, coords, g, dcorr, dcoords, bq, h0, w0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
