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
// What bounds it on an H100: bytes. g is read and d_img written once, 10
// flops per sample-channel against 8-12 bytes; at the training step's largest
// warp (B=10, N=65536, C=64 onto 256x256) that is 0.105 ms at 3.35 TB/s. A
// scatter with f32 atomics into device memory (this kernel's first version)
// serialises 4*N*C read-modify-writes in L2 and needs a memset of d_img
// besides: 0.405 ms there. On the card, an f32 atomicAdd on shared memory is
// a compare-and-swap loop, so this design needs none.
//
// Design: the output owns its tile, as in the TPU kernel, where the output
// block stays resident while every sample that reaches it is added in.
//  1. splat_bin_count_kernel: one thread per sample finds the bins its
//     in-image taps touch and counts it into each (warp-aggregated int
//     atomics on the counts). A bin is 2 rows x 8 columns of pixels: the
//     rows one accumulating warp owns in one tile. A sample lies in at most
//     four bins.
//  2. The wrapper turns the counts into bin ends with a torch cumsum.
//  3. splat_bin_fill_kernel: each sample claims a slot in each of its bins
//     (same aggregation) and writes its index there. Slots are int32, sized
//     for the worst case (4 per sample); there is no host sync.
//  4. splat_accumulate_kernel: one 256-thread block per (batch, 16x8 tile,
//     64-channel slice) zeroes its f32 tile in shared memory (32 KB). Warp v
//     owns tile rows 2v and 2v + 1 and reads their bin, 32 entries at a time
//     with the next group's loads in flight; it takes each sample's g row
//     (one 8-byte load a lane, two channels a lane) and adds its taps into
//     its own rows with plain shared-memory loads and stores: no other warp
//     writes them, so there are no atomics and no barrier until the tile is
//     finished. The tile is written once with 16-byte stores. No global
//     atomics on d_img and no memset: every output element is written
//     exactly once, by its owner, zero or not.
//  Images of at most 256 pixels (8 and 16 px) skip steps 1-3: each warp
//  then reads every sample of its batch and keeps those with a tap in its
//  rows.
// Bytes: g is read once per bin its sample lies in (about 1.7x from L2 on
// smooth flows, once from device memory), d_img written once. The order in
// which a warp adds a bin's samples follows the slots' claims, so f32
// roundings may differ between launches. A flow that collapses many samples
// onto a few pixels makes a few bins long and their warps slow, but not
// wrong. Offsets into g and d_img are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileH = 16;                // output tile rows
constexpr int kTileW = 8;                 // output tile columns
constexpr int kTilePix = kTileH * kTileW;  // 128
constexpr int kSlice = 64;                // channels per accumulating block, two a lane
constexpr int kRowsPerWarp = 2;           // tile rows an accumulating warp owns
constexpr int kBinH = kRowsPerWarp;       // a bin: one warp's rows of a tile
constexpr int kWarps = kTileH / kRowsPerWarp;
constexpr int kThreads = 32 * kWarps;     // an accumulating block
constexpr int kBinThreads = 256;          // a binning block
constexpr int kBatch = 4;  // g rows in flight per warp
constexpr int kBias = kTileW + 1;  // (ya, xa) may lie a row above, a column left

// Round an f32 value to the gradient's dtype and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The same for a pair of values (one packed conversion in bf16).
template <typename T>
__device__ __forceinline__ float2 round_pair(float2 v);
template <>
__device__ __forceinline__ float2 round_pair<float>(float2 v) { return v; }
template <>
__device__ __forceinline__ float2 round_pair<__nv_bfloat16>(float2 v) {
  return __bfloat1622float2(__float22bfloat162_rn(v));
}

__device__ __forceinline__ int clip(int i, int size) { return min(max(i, -1), size); }

// Channels ch and ch + 1 of a g row (from its slice start) as f32, zero past
// `width`; one 8-byte (f32) or 4-byte (bf16) load when the pair is aligned.
__device__ __forceinline__ float2 load_pair(const float* row, int ch, int width, bool pairs) {
  if (pairs && ch + 1 < width) return *reinterpret_cast<const float2*>(row + ch);
  return make_float2(ch < width ? row[ch] : 0.f, ch + 1 < width ? row[ch + 1] : 0.f);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row, int ch, int width,
                                            bool pairs) {
  if (pairs && ch + 1 < width) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + ch));
  }
  return make_float2(ch < width ? __bfloat162float(row[ch]) : 0.f,
                     ch + 1 < width ? __bfloat162float(row[ch + 1]) : 0.f);
}

// The two tap indices of a sample along one axis, clipped as the JAX splat
// clips them, and the distinct bins (along this axis) their in-image taps
// fall in (-1: none).
struct Axis {
  int a, b;    // clipped tap indices a and a + 1
  int ta, tb;  // bin of a, bin of b when it differs from ta; -1 if none
};

__device__ __forceinline__ Axis axis(int i0, int size, int tile) {
  Axis r;
  r.a = clip(i0, size);
  r.b = clip(r.a + 1, size);
  const bool a_in = r.a >= 0 && r.a < size;
  const bool b_in = r.b >= 0 && r.b < size;
  r.ta = a_in ? r.a / tile : -1;
  r.tb = (b_in && (!a_in || r.b / tile != r.ta)) ? r.b / tile : -1;
  return r;
}

// Bin k (0..3) of sample s, or -1: the (bin row, bin column) pairs of its
// in-image taps, each distinct pair once.
__device__ __forceinline__ int bin_of(int k, const Axis& ay, const Axis& ax, int b, int ntx,
                                      int tiles) {
  const int ty = (k & 2) ? ay.tb : ay.ta;
  const int tx = (k & 1) ? ax.tb : ax.ta;
  return (ty >= 0 && tx >= 0) ? b * tiles + ty * ntx + tx : -1;
}

// Counting (slots == nullptr) or filling the bins: each lane takes one sample;
// lanes with the same bin share one atomic, and a lane's slot is its rank
// among them.
__device__ __forceinline__ void bin_samples(const int* __restrict__ y0, const int* __restrict__ x0,
                                            int* __restrict__ counter, int* __restrict__ slots,
                                            int64_t total, int n, int h, int w, int ntx,
                                            int tiles) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kBinThreads + threadIdx.x;
  const bool live = s < total;
  const int lane = threadIdx.x & 31;
  Axis ay{}, ax{};
  int b = 0;
  if (live) {
    b = static_cast<int>(s / n);
    ay = axis(__ldg(y0 + s), h, kBinH);
    ax = axis(__ldg(x0 + s), w, kTileW);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int key = live ? bin_of(k, ay, ax, b, ntx, tiles) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (key < 0) continue;
    const int leader = __ffs(same) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(counter + key, __popc(same));
    base = __shfl_sync(same, base, leader);
    if (slots != nullptr) {
      slots[base + __popc(same & ((1u << lane) - 1u))] = static_cast<int>(s);
    }
  }
}

__global__ void __launch_bounds__(kBinThreads)
splat_bin_count_kernel(const int* __restrict__ y0, const int* __restrict__ x0,
                       int* __restrict__ counts, int64_t total, int n, int h, int w, int ntx,
                       int tiles) {
  bin_samples(y0, x0, counts, nullptr, total, n, h, w, ntx, tiles);
}

// cursor: each bin's start on entry (end - count); its end on return.
__global__ void __launch_bounds__(kBinThreads)
splat_bin_fill_kernel(const int* __restrict__ y0, const int* __restrict__ x0,
                      int* __restrict__ cursor, int* __restrict__ slots, int64_t total, int n,
                      int h, int w, int ntx, int tiles) {
  bin_samples(y0, x0, cursor, slots, total, n, h, w, ntx, tiles);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
splat_accumulate_kernel(const T* __restrict__ g, const int* __restrict__ y0,
                        const float* __restrict__ wy0, const float* __restrict__ wy1,
                        const int* __restrict__ x0, const float* __restrict__ wx0,
                        const float* __restrict__ wx1, const int* __restrict__ counts,
                        const int* __restrict__ ends, const int* __restrict__ slots,
                        float* __restrict__ out, int n, int c, int h, int w) {
  __shared__ __align__(16) float tile[kTilePix * kSlice];  // [pixel][channel]

  const int ntx = (w + kTileW - 1) / kTileW;
  const int nty = (h + kTileH - 1) / kTileH;  // tiles a batch
  const int nby = (h + kBinH - 1) / kBinH;     // bin rows a batch
  const int b = blockIdx.x / (nty * ntx);
  const int t = blockIdx.x - b * nty * ntx;
  const int ty = t / ntx;
  const int tx = t - ty * ntx;
  const int py = ty * kTileH;
  const int px = tx * kTileW;
  const int cbase = blockIdx.y * kSlice;
  const int width = min(kSlice, c - cbase);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float4* tile4 = reinterpret_cast<float4*>(tile);
  for (int i = tid; i < kTilePix * kSlice / 4; i += kThreads) {
    tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  // binned: the bin of this warp's rows; direct (no slots): every sample of
  // the batch
  const int band = ty * kWarps + warp;
  int start = 0, end = 0;
  if (band < nby) {
    if (slots != nullptr) {
      const int bin = (b * nby + band) * ntx + tx;
      end = ends[bin];
      start = end - counts[bin];
    } else {
      end = n;
    }
  }
  // Warp v owns kRowsPerWarp tile rows from row kRowsPerWarp * v. It reads
  // their bin 32 entries at a time, one a lane, keeps the samples with a tap
  // in its rows, and adds them in, two channels a lane: no other warp writes
  // its rows, so the adds are plain shared-memory loads and stores, and the
  // warps need no barrier until the tile is finished.
  const bool pairs = (c & 1) == 0;  // channel pairs 8-byte (f32) / 4-byte aligned
  const int ch = 2 * lane;
  // The bin is read in a two-deep pipeline, so that its loads are in flight
  // while the warp adds the group before: the slots one group ahead, each
  // sample's corners and weights before the adds of the group ahead of it.
  auto slot_at = [&](int i) {
    return i < end ? (slots != nullptr ? __ldg(slots + i) : b * n + i) : -1;
  };
  struct Meta {
    int ya, xa;
    float w[4];
  };
  auto meta_at = [&](int si) {
    Meta m{0, 0, {0.f, 0.f, 0.f, 0.f}};
    if (si >= 0) {
      m.ya = __ldg(y0 + si);
      m.xa = __ldg(x0 + si);
      m.w[0] = __ldg(wy0 + si);
      m.w[1] = __ldg(wy1 + si);
      m.w[2] = __ldg(wx0 + si);
      m.w[3] = __ldg(wx1 + si);
    }
    return m;
  };
  int s_cur = slot_at(start + lane);
  int s_nxt = slot_at(start + 32 + lane);
  Meta m_cur = meta_at(s_cur);
  for (int i0 = start; i0 < end; i0 += 32) {
    const int s = s_cur;
    // this warp's taps: bits 0-3 say which of (ya, xa), (ya, xb), (yb, xa),
    // (yb, xb) lie in its rows; bits 8 and up hold the pixel offset of
    // (ya, xa) in its rows, plus kBias (it may lie a row or column outside)
    unsigned packed = 0;
    float wts[4];
    if (s >= 0) {
      const int ya = clip(m_cur.ya, h);
      const int xa = clip(m_cur.xa, w);
      const int yb = clip(ya + 1, h);
      const int xb = clip(xa + 1, w);
      // a tap is this warp's if it lies in the image, in the tile and in
      // the warp's rows
      const int r0 = py + kRowsPerWarp * warp;
      const int ra = (ya >= r0 && ya < r0 + kRowsPerWarp && ya < h) ? ya - r0 : -1;
      const int rb = (yb >= r0 && yb < r0 + kRowsPerWarp && yb < h) ? yb - r0 : -1;
      const int ca = (xa >= px && xa < px + kTileW && xa < w) ? xa - px : -1;
      const int cb = (xb >= px && xb < px + kTileW && xb < w) ? xb - px : -1;
      const unsigned flags = (ra >= 0 && ca >= 0) | (ra >= 0 && cb >= 0) << 1 |
                             (rb >= 0 && ca >= 0) << 2 | (rb >= 0 && cb >= 0) << 3;
      if (flags != 0) {
        packed = flags | static_cast<unsigned>((ya - r0) * kTileW + xa - px + kBias) << 8;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) wts[k] = round_to<T>(m_cur.w[k]);
    // the next group's metadata and the slots of the one after it
    m_cur = meta_at(s_nxt);
    s_cur = s_nxt;
    s_nxt = slot_at(i0 + 64 + lane);
    unsigned todo = __ballot_sync(0xffffffffu, packed != 0);
    while (todo != 0) {
      // up to kBatch of the kept samples: their g rows first, then the adds
      int src[kBatch];
      float2 gv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        src[u] = todo != 0 ? __ffs(todo) - 1 : -1;
        todo &= todo - 1;
        const int su = __shfl_sync(0xffffffffu, s, src[u] < 0 ? 0 : src[u]);
        gv[u] = src[u] >= 0
                    ? load_pair(g + static_cast<int64_t>(su) * c + cbase, ch, width, pairs)
                    : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (src[u] < 0) break;
        const unsigned pk = __shfl_sync(0xffffffffu, packed, src[u]);
        const float wya = __shfl_sync(0xffffffffu, wts[0], src[u]);
        const float wyb = __shfl_sync(0xffffffffu, wts[1], src[u]);
        const float wxa = __shfl_sync(0xffffffffu, wts[2], src[u]);
        const float wxb = __shfl_sync(0xffffffffu, wts[3], src[u]);
        const float2 ua =
            round_pair<T>(make_float2(__fmul_rn(wxa, gv[u].x), __fmul_rn(wxa, gv[u].y)));
        const float2 ub =
            round_pair<T>(make_float2(__fmul_rn(wxb, gv[u].x), __fmul_rn(wxb, gv[u].y)));
        // the four taps, four distinct pixels of this warp's rows where
        // their flags (the same on every lane) say so; this lane's channels
        float2* at = reinterpret_cast<float2*>(tile + warp * kRowsPerWarp * kTileW * kSlice) +
                     (static_cast<int>(pk >> 8) - kBias) * (kSlice / 2) + lane;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(pk & (1u << k)) || ch >= width) continue;
          const float wy = k < 2 ? wya : wyb;
          const float2 ux = (k & 1) ? ub : ua;
          const int off = ((k & 1) + (k >> 1) * kTileW) * (kSlice / 2);  // column, row step
          const float2 acc = at[off];
          at[off] = make_float2(__fadd_rn(acc.x, __fmul_rn(wy, ux.x)),
                                __fadd_rn(acc.y, __fmul_rn(wy, ux.y)));
        }
      }
    }
  }
  __syncthreads();
  // the finished tile, once: pixels inside the image, this slice's channels
  const int nrows = min(kTileH, h - py);
  const int ncols = min(kTileW, w - px);
  float* img = out + static_cast<int64_t>(b) * h * w * c + cbase;
  if (width == kSlice && c % 4 == 0) {  // 16-byte stores, 16 threads a pixel
    constexpr int kVec = kSlice / 4;
    for (int i = tid; i < kTilePix * kVec; i += kThreads) {
      const int p = i / kVec;
      const int r = p / kTileW;
      const int q = p - r * kTileW;
      if (r < nrows && q < ncols) {
        const int64_t o = (static_cast<int64_t>(py + r) * w + px + q) * c;
        reinterpret_cast<float4*>(img + o)[i - p * kVec] = tile4[i];
      }
    }
  } else {
    for (int i = tid; i < kTilePix * kSlice; i += kThreads) {
      const int p = i / kSlice;
      const int k = i - p * kSlice;
      const int r = p / kTileW;
      const int q = p - r * kTileW;
      if (r < nrows && q < ncols && k < width) {
        img[(static_cast<int64_t>(py + r) * w + px + q) * c + k] = tile[i];
      }
    }
  }
}

unsigned blocks_for(int64_t total) {
  return static_cast<unsigned>((total + kBinThreads - 1) / kBinThreads);
}

}  // namespace

// The bins' rows (axis 0) and columns (axis 1) of pixels: per batch
// ceil(h / rows) x ceil(w / columns) bins, row-major.
extern "C" int mrfa_splat_tile(int axis) { return axis == 0 ? kBinH : kTileW; }

// Pass 1. y0, x0: (b, n) int32; counts: (b * bins) int32, zeroed by the
// caller; bins = ceil(h / 2) * ceil(w / 8) a batch. b * n >= 1.
extern "C" int mrfa_splat_bin_count(const void* y0, const void* x0, void* counts, int64_t b,
                                    int64_t n, int h, int w, void* stream) {
  const int ntx = (w + kTileW - 1) / kTileW;
  const int tiles = ((h + kBinH - 1) / kBinH) * ntx;
  const int64_t total = b * n;
  splat_bin_count_kernel<<<blocks_for(total), kBinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(y0), static_cast<const int*>(x0), static_cast<int*>(counts), total,
      static_cast<int>(n), h, w, ntx, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2. cursor: (b * bins) int32, each bin's first slot on entry (its end
// minus its count) and its end on return; slots: int32, room for every
// sample's bins (4 * b * n at most).
extern "C" int mrfa_splat_bin_fill(const void* y0, const void* x0, void* cursor, void* slots,
                                   int64_t b, int64_t n, int h, int w, void* stream) {
  const int ntx = (w + kTileW - 1) / kTileW;
  const int tiles = ((h + kBinH - 1) / kBinH) * ntx;
  const int64_t total = b * n;
  splat_bin_fill_kernel<<<blocks_for(total), kBinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(y0), static_cast<const int*>(x0), static_cast<int*>(cursor),
      static_cast<int*>(slots), total, static_cast<int>(n), h, w, ntx, tiles);
  return static_cast<int>(cudaGetLastError());
}

// Pass 3. g: (b, n, c) f32 (is_bf16 == 0) or bf16; wy0, wy1, wx0, wx1: (b, n)
// f32; counts, ends: the bins' counts and ends, slots as filled, or all three
// null (direct: each tile takes every sample of its batch, for images of a
// few tiles); out: (b, h, w, c) f32, every element written. All contiguous.
extern "C" int mrfa_splat_accumulate(const void* g, const void* y0, const void* wy0,
                                     const void* wy1, const void* x0, const void* wx0,
                                     const void* wx1, const void* counts, const void* ends,
                                     const void* slots, void* out, int64_t b, int64_t n, int c,
                                     int h, int w, int is_bf16, void* stream) {
  const int tiles = ((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  const dim3 grid(static_cast<unsigned>(b * tiles),
                  static_cast<unsigned>((c + kSlice - 1) / kSlice));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ci = static_cast<const int*>(counts);
  const int* ei = static_cast<const int*>(ends);
  const int* si = static_cast<const int*>(slots);
  const int* yi = static_cast<const int*>(y0);
  const int* xi = static_cast<const int*>(x0);
  const float* a = static_cast<const float*>(wy0);
  const float* bb = static_cast<const float*>(wy1);
  const float* d = static_cast<const float*>(wx0);
  const float* e = static_cast<const float*>(wx1);
  if (is_bf16) {
    splat_accumulate_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), yi, a, bb, xi, d, e, ci, ei, si,
        static_cast<float*>(out), static_cast<int>(n), c, h, w);
  } else {
    splat_accumulate_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), yi, a, bb, xi, d, e, ci, ei, si,
        static_cast<float*>(out), static_cast<int>(n), c, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
