// Bilinear warp forward: out[b, c, n] = the bilinear sample of img[b, c] at
// the pixel coordinates (ix[b, n], iy[b, n]).
//
// Replaces no TPU kernel: the JAX package's forward is an XLA gather
// (mrfa_tpu/ops/sampler.py::_bilinear_core). Its port was plain PyTorch
// (ops/sampler.py::warp_pixels_plain): a padded copy of the image, about a
// dozen small kernels of int64 corner indices, a (B, C, 4, N) gather, an f32
// product of the same width and its sum, ~31 launches a warp. This is one.
//
// Semantics, those of the plain version: coordinates are f32; with
// `zero_oob` they are clamped to [-1, size] before the floor; corners are
// clamped to [-1, size] (a no-op with `zero_oob`, whose callers' coordinates
// otherwise lie inside the image) and a tap outside the image reads zero.
// The four taps are read in the image dtype (f32 or bf16), the weights and
// the blend are f32, summed in tap order p00, p10 (x + 1), p01 (y + 1), p11
// with every product and sum rounded (__fmul_rn / __fadd_rn, no FMA
// contraction), and the result is rounded once to the image dtype. With
// `unnorm`, the coordinates are normalized grid values mapped to pixels as
// ops/sampler.py::_unnormalize does, ((g + 1) * a - b) * c per axis, so a
// zero-padded grid_sample needs no kernels of its own before this one.
//
// What bounds it on an H100: bytes. A warp must write B*C*N outputs and read
// each source plane about once (the taps of a smooth flow fall on
// neighbouring pixels, so they are served from L1 and L2), plus the two
// coordinates of every point: B*C*(N + H*W)*itemsize + 8*B*N bytes, for
// ~7 f32 operations an output.
//
// Design: one thread a point. It reads the point's coordinates once (through
// element strides, so a (B, N, 2) grid is read in place), computes its four
// corners, validity and weights once, and then loops over a chunk of the
// channels: four loads, the blend, one store a channel, the loads of four
// channels issued before their blends, so that 16 are in flight a thread. Points (b, n) are
// flattened over the batch, and neighbouring threads take neighbouring
// points, so the stores along N coalesce and the taps of a warp fall on
// neighbouring source pixels. The grid is (point blocks, channel chunks):
// the chunk count follows the shape so that a warp of few points and many
// channels (8x8 at 512 channels) still fills the SMs, and one of many points
// keeps its whole channel loop in one thread. The image and the output are
// read and written through their strides; NCHW is what the speed is for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// Mirrored by ops/sampler.py::_WarpArgs (ctypes.Structure, same field order).
// Outside the anonymous namespace: the exported functions take it, and a
// type of internal linkage would give them internal linkage too.
struct WarpArgs {
  const void* img;  // (B, C, H, W), strides in elements
  const float* ix;  // (B, N)
  const float* iy;  // (B, N)
  void* out;        // (B, C, N), in img's dtype
  int64_t b, c, h, w, n;
  int64_t img_sb, img_sc, img_sh, img_sw;
  int64_t ix_sb, ix_sn, iy_sb, iy_sn;
  int64_t out_sb, out_sc, out_sn;
  float ax, bx, cx, ay, by, cy;  // with unnorm: pixel = ((g + 1) * a - b) * c
  int32_t unnorm, zero_oob, is_bf16;
};

namespace {

constexpr int kThreads = 256;  // points a block
constexpr int kBlocksPerSm = 2048 / kThreads;  // resident blocks an SM at full occupancy
constexpr int kUnroll = 4;  // channels a thread loads before it blends
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The plain version's blend: products and sums in tap order, each rounded.
__device__ __forceinline__ float blend(float w00, float w10, float w01, float w11,
                                       const float* p) {
  float v = __fmul_rn(w00, p[0]);
  v = __fadd_rn(v, __fmul_rn(w10, p[1]));
  v = __fadd_rn(v, __fmul_rn(w01, p[2]));
  return __fadd_rn(v, __fmul_rn(w11, p[3]));
}

__device__ __forceinline__ float unnormalize(float g, float a, float b, float c) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), a), b), c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const WarpArgs a, int64_t per_chunk) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= a.b * a.n) return;
  const int64_t c_begin = static_cast<int64_t>(blockIdx.y) * per_chunk;
  const int64_t c_end = c_begin + per_chunk < a.c ? c_begin + per_chunk : a.c;
  const int64_t bi = p / a.n;
  const int64_t ni = p - bi * a.n;

  float x = __ldg(a.ix + bi * a.ix_sb + ni * a.ix_sn);
  float y = __ldg(a.iy + bi * a.iy_sb + ni * a.iy_sn);
  if (a.unnorm) {
    x = unnormalize(x, a.ax, a.bx, a.cx);
    y = unnormalize(y, a.ay, a.by, a.cy);
  }
  const float wf = static_cast<float>(a.w);
  const float hf = static_cast<float>(a.h);
  if (a.zero_oob) {
    // beyond one pixel outside, every tap reads zero either way
    x = clamp_nan(x, -1.0f, wf);
    y = clamp_nan(y, -1.0f, hf);
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f);
  const float wy = __fsub_rn(y, y0f);
  const float gx = __fsub_rn(1.0f, wx);
  const float gy = __fsub_rn(1.0f, wy);
  const float w00 = __fmul_rn(gx, gy);
  const float w10 = __fmul_rn(wx, gy);
  const float w01 = __fmul_rn(gx, wy);
  const float w11 = __fmul_rn(wx, wy);
  // corners clamped to [-1, size] before the integer conversion (NaN -> -1)
  const int64_t x0 = static_cast<int64_t>(fminf(fmaxf(x0f, -1.0f), wf));
  const int64_t y0 = static_cast<int64_t>(fminf(fmaxf(y0f, -1.0f), hf));
  const bool vx0 = x0 >= 0 && x0 < a.w;
  const bool vx1 = x0 + 1 < a.w;  // x0 + 1 >= 0 always
  const bool vy0 = y0 >= 0 && y0 < a.h;
  const bool vy1 = y0 + 1 < a.h;
  const bool v00 = vx0 && vy0, v10 = vx1 && vy0, v01 = vx0 && vy1, v11 = vx1 && vy1;
  const int64_t o00 = y0 * a.img_sh + x0 * a.img_sw;
  const int64_t o10 = o00 + a.img_sw;
  const int64_t o01 = o00 + a.img_sh;
  const int64_t o11 = o01 + a.img_sw;

  const T* __restrict__ src =
      static_cast<const T*>(a.img) + bi * a.img_sb + c_begin * a.img_sc;
  T* __restrict__ dst =
      static_cast<T*>(a.out) + bi * a.out_sb + c_begin * a.out_sc + ni * a.out_sn;
  const int count = static_cast<int>(c_end - c_begin);
  int k = 0;
  // kUnroll channels at a time: every load of the group is issued before
  // the first blend and store, so 4 * kUnroll loads are in flight a thread
  for (; k + kUnroll <= count; k += kUnroll) {
    float p[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T* s = src + u * a.img_sc;
      p[u][0] = v00 ? load_f32(s + o00) : 0.0f;
      p[u][1] = v10 ? load_f32(s + o10) : 0.0f;
      p[u][2] = v01 ? load_f32(s + o01) : 0.0f;
      p[u][3] = v11 ? load_f32(s + o11) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      store_out(dst + u * a.out_sc, blend(w00, w10, w01, w11, p[u]));
    }
    src += kUnroll * a.img_sc;
    dst += kUnroll * a.out_sc;
  }
  for (; k < count; ++k) {
    float p[4];
    p[0] = v00 ? load_f32(src + o00) : 0.0f;
    p[1] = v10 ? load_f32(src + o10) : 0.0f;
    p[2] = v01 ? load_f32(src + o01) : 0.0f;
    p[3] = v11 ? load_f32(src + o11) : 0.0f;
    store_out(dst, blend(w00, w10, w01, w11, p));
    src += a.img_sc;
    dst += a.out_sc;
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms > 0 ? sms : 132;
  }
  return cached[dev];
}

// Channel chunks: enough blocks for two rounds of full occupancy, no more
// chunks than channels, and equal chunks.
void launch_plan(const WarpArgs& a, int64_t* point_blocks, int64_t* chunks,
                 int64_t* per_chunk) {
  *point_blocks = (a.b * a.n + kThreads - 1) / kThreads;
  const int64_t target = 2LL * kBlocksPerSm * sm_count();
  int64_t want = (target + *point_blocks - 1) / *point_blocks;
  if (want > a.c) want = a.c;
  if (want < 1) want = 1;
  *per_chunk = (a.c + want - 1) / want;
  *chunks = (a.c + *per_chunk - 1) / *per_chunk;
}

}  // namespace

// The wrapper checks its ctypes mirror of WarpArgs against this.
extern "C" int mrfa_warp_bilinear_args_size() { return static_cast<int>(sizeof(WarpArgs)); }

// B, C, N >= 1 (the chunks are at most 2 * kBlocksPerSm * SMs). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mrfa_warp_bilinear(const WarpArgs* a, void* stream) {
  int64_t point_blocks, chunks, per_chunk;
  launch_plan(*a, &point_blocks, &chunks, &per_chunk);
  const dim3 grid(static_cast<unsigned>(point_blocks), static_cast<unsigned>(chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->is_bf16) {
    warp_bilinear_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(*a, per_chunk);
  } else {
    warp_bilinear_kernel<float><<<grid, kThreads, 0, s>>>(*a, per_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
