// The image gradient of a bilinear warp (the "splat"):
//   d_img[b, y, x, c] = sum_n WY[b, n, y] * WX[b, n, x] * g[b, n, c],
// WY / WX the weighted one-hot pairs of each sample: wy0 at row y0 and wy1 at
// y0 + 1 (likewise along x), with the indices clipped to [-1, size] so that
// out-of-range taps fall on no pixel and drop.
//
// Replaces the TPU kernel mrfa_tpu/ops/pallas_splat.py::_splat_kernel, reached
// through sampler._splat_dispatch from the custom VJP of every bilinear warp.
// Rounding as there and in the plain version (ops/splat.py::splat_plain): the
// pair weights are cast to g's dtype, u = wx * g is rounded to that dtype,
// and the products wy * u accumulate in f32.
//
// What bounds it on an H100: the f32 atomic additions. Each sample scatters
// four taps of C channels into an output that many samples share, so the
// work is 4*N*C read-modify-writes in L2 against 12 bytes of input per
// sample-channel; at the training step's largest warp (B=10, N=65536, C=64)
// that is 168 M atomics.
//
// Design (first, simple version): one thread per (sample, channel). The
// threads of a warp cover consecutive channels of one or a few samples, so
// the g loads are coalesced and each tap's atomics land on consecutive
// addresses of one pixel row (one L2 transaction per 32 channels). The
// wrapper zeroes d_img; taps outside the image are skipped, never written.
// Offsets are 64-bit: B*H*W*C reaches 42 M elements per warp. Sorting the
// samples or accumulating owner-computes tiles in shared memory is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round an f32 value to the gradient's dtype and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int clip(int i, int size) { return min(max(i, -1), size); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
splat_kernel(const T* __restrict__ g, const int* __restrict__ y0, const float* __restrict__ wy0,
             const float* __restrict__ wy1, const int* __restrict__ x0,
             const float* __restrict__ wx0, const float* __restrict__ wx1,
             float* __restrict__ out, int64_t n, int c, int h, int w, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t s = idx / c;  // b * n + sample
  const int ch = static_cast<int>(idx - s * c);
  const int64_t b = s / n;

  const int ya = clip(__ldg(y0 + s), h);
  const int yb = clip(ya + 1, h);
  const int xa = clip(__ldg(x0 + s), w);
  const int xb = clip(xa + 1, w);
  const float wya = round_to<T>(__ldg(wy0 + s));
  const float wyb = round_to<T>(__ldg(wy1 + s));
  const float gv = to_f32(g[idx]);
  const float ua = round_to<T>(__fmul_rn(round_to<T>(__ldg(wx0 + s)), gv));
  const float ub = round_to<T>(__fmul_rn(round_to<T>(__ldg(wx1 + s)), gv));

  float* img = out + b * static_cast<int64_t>(h) * w * c + ch;
  const bool ya_in = ya >= 0 && ya < h;
  const bool yb_in = yb >= 0 && yb < h;
  const bool xa_in = xa >= 0 && xa < w;
  const bool xb_in = xb >= 0 && xb < w;
  if (ya_in && xa_in) atomicAdd(img + (static_cast<int64_t>(ya) * w + xa) * c, __fmul_rn(wya, ua));
  if (ya_in && xb_in) atomicAdd(img + (static_cast<int64_t>(ya) * w + xb) * c, __fmul_rn(wya, ub));
  if (yb_in && xa_in) atomicAdd(img + (static_cast<int64_t>(yb) * w + xa) * c, __fmul_rn(wyb, ua));
  if (yb_in && xb_in) atomicAdd(img + (static_cast<int64_t>(yb) * w + xb) * c, __fmul_rn(wyb, ub));
}

template <typename T>
void launch(const void* g, const void* y0, const void* wy0, const void* wy1, const void* x0,
            const void* wx0, const void* wx1, void* out, int64_t b, int64_t n, int c, int h,
            int w, cudaStream_t stream) {
  const int64_t total = b * n * c;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  splat_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int*>(y0), static_cast<const float*>(wy0),
      static_cast<const float*>(wy1), static_cast<const int*>(x0),
      static_cast<const float*>(wx0), static_cast<const float*>(wx1),
      static_cast<float*>(out), n, c, h, w, total);
}

}  // namespace

// g: (b, n, c) f32 (is_bf16 == 0) or bf16; y0, x0: (b, n) int32; wy0, wy1,
// wx0, wx1: (b, n) f32; out: (b, h, w, c) f32, zeroed by the caller. All
// contiguous; b * n * c >= 1. Launches on `stream`, returns cudaGetLastError().
extern "C" int mrfa_splat(const void* g, const void* y0, const void* wy0, const void* wy1,
                          const void* x0, const void* wx0, const void* wx1, void* out,
                          int64_t b, int64_t n, int c, int h, int w, int is_bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(g, y0, wy0, wy1, x0, wx0, wx1, out, b, n, c, h, w, s);
  } else {
    launch<float>(g, y0, wy0, wy1, x0, wx0, wx1, out, b, n, c, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
