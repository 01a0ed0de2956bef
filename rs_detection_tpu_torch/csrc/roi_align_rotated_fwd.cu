// Rotated RoIAlign over an FPN pyramid, forward (K1), for Hopper (sm_90a):
// one warp per row of bins, the row's sampling geometry worked out once.
//
// Replaces: rs_detection_tpu/ops/pallas_roi_align.py, `_pool_kernel`
// (reached through `roi_align_rotated_pyramid_pallas`), the RoI stage of
// Oriented R-CNN, for features whose channels come in 16-byte vectors (C a
// multiple of 8 in bf16 or 4 in f32, 16-byte aligned levels) at S = 1 or 2
// samples per bin side. It computes the function of the first design
// (roi_align_rotated.cu), the exact one of
// rs_detection_tpu/ops/roi_align.py:roi_align_rotated_pyramid for every roi,
// through the same `roi_geom` / `sample_corners` (roi_align.cuh): level,
// border rules and batch clamp cannot drift apart. Sums are f32, rounded once
// to the features' dtype. The first design stays for one channel per lane and
// as the reference this one is timed against
// (ops/roi_align.py:roi_align_rotated_pyramid_first_design).
//
// What bounds it on the H100 (16000 rois, C = 256, bf16; phase cuts of
// tools/k1k7_designs.py, NVIDIA H100 80GB HBM3 at 700 W): the corner loads.
// The compulsory bytes (the pyramid read once, 401 MB of output) take 0.226
// ms, but a bin reads 16 corner rows of 512 bytes, ~6.4 GB in all, through
// L1 and L2. The first design spent 0.35 of its 0.65 ms on geometry: every
// lane of a bin's warp worked out all four samples, and each sample's loads
// waited behind its `continue`. Here the geometry alone takes 0.19 ms (with
// the output's stores) and the loads alone 0.41; the whole 0.51. This design:
//   - A warp owns one row of bins of one roi (P bins): every warp has the
//     same work, no 7-against-6 tail over a block's warps.
//   - The row's P * S * S samples are worked out once, one per lane (28 of
//     32 lanes at P = 7, S = 2), into a table of (pixel, weight) per corner
//     in shared memory; a dead sample gets pixel -1 and weight 0.
//   - At S = 2 a bin whose live corners fit a 3 x 3 pixel window (samples
//     less than a pixel apart: rois small on their level) holds that window
//     instead, each pixel's weights added: 9 loads for 16 (0.06 ms).
//   - Per bin each lane reads the bin's table entries (broadcast reads), then
//     issues all its corner loads (16-byte vectors, predicated off where the
//     pixel is -1: no branch) before the first FMA.
//   - From 8192 rois the warps take them in an order bucketed by level,
//     image and 16 x 16-pixel cell (one block orders them, ~0.03 ms), so
//     warps that run together read neighbouring pixels from the L2 (0.08 ms
//     less in the kernel on 16000 uniform rois).
//   - Three blocks of 8 warps an SM (80 registers): two or four measured
//     slower.
// A lane owns one 16-byte vector of channels (8 bf16 or 4 f32) per bin and
// loops over the vectors past 32 per row.

#include <limits.h>
#include <stdint.h>

#include "roi_align.cuh"

namespace {

using namespace rs;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// a[v] += w * (the v-th value of the 16-byte vector q)
template <typename T>
__device__ __forceinline__ void fma16(const uint4& q, float w, float* a);

template <>
__device__ __forceinline__ void fma16<__nv_bfloat16>(const uint4& q, float w,
                                                     float* a) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] += w * __uint_as_float(u[i] << 16);
    a[2 * i + 1] += w * __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void fma16<float>(const uint4& q, float w,
                                             float* a) {
  a[0] += w * __uint_as_float(q.x);
  a[1] += w * __uint_as_float(q.y);
  a[2] += w * __uint_as_float(q.z);
  a[3] += w * __uint_as_float(q.w);
}

// Corners that coincide within a bin are merged (weights added) when all of
// the bin's live corners fit a 3 x 3 pixel window: a roi smaller than its
// level's pixels then loads each pixel once per bin, 9 loads for 16.
constexpr bool MERGE = true;
constexpr int MERGED = 9;

__host__ __device__ inline size_t table_bytes(int P, int S) {
  // per warp and row: an int pixel and an f32 weight per corner of every
  // sample, and the count of table entries of each bin
  return static_cast<size_t>(WARPS) * P * (S * S * 4 * 8 + 4);
}

// The sums of one bin over its first `n` table entries, for every vector of
// channels of this lane, stored once.
template <typename T, int N>
__device__ __forceinline__ void bin_sums(const int* to_s, const float* tw_s,
                                         const T* feat, int C, int lane,
                                         float scale, T* out) {
  constexpr int VEC = 16 / sizeof(T);
  int to[N];
  float tw[N];
#pragma unroll
  for (int j = 0; j < N; ++j) to[j] = to_s[j], tw[j] = tw_s[j];
  for (int c0 = lane * VEC; c0 < C; c0 += 32 * VEC) {
    uint4 q[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      q[j] = to[j] >= 0 ? ldg16(feat + static_cast<size_t>(to[j]) * C + c0)
                        : make_uint4(0u, 0u, 0u, 0u);
    float a[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) fma16<T>(q[j], tw[j], a);
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] *= scale;
    Vec<T, VEC>::store(out + c0, a);
  }
}

// order: null, or the roi of each task row (rois bucketed so that warps that
// run together read neighbouring pixels); the output slot stays the roi's.
template <typename T, int S>
__global__ void __launch_bounds__(THREADS, 3)
    roi_rows_kernel(Pyramid pyr, int num_levels, int N, int C,
                    const float* __restrict__ rois,
                    const long long* __restrict__ order, int R, int P,
                    float finest_scale, T* __restrict__ out) {
  constexpr int SS = S * S;
  constexpr int CORNERS = 4 * SS;  // per bin
  constexpr bool merge = MERGE && CORNERS > MERGED;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * WARPS + warp;  // (roi, row of bins)
  if (task >= R * P) return;  // warp-uniform; no block barrier follows
  const int t = task / P;
  const int r = order != nullptr ? static_cast<int>(order[t]) : t;
  const int py = task - t * P;
  const int row = P * CORNERS;  // table entries of a row
  int* to_s = reinterpret_cast<int*>(smem) + warp * row;
  float* tw_s = reinterpret_cast<float*>(smem) + WARPS * row + warp * row;
  int* cnt_s = reinterpret_cast<int*>(smem) + 2 * WARPS * row + warp * P;

  const RoiGeom g = roi_geom(pyr, num_levels, N,
                             rois + static_cast<size_t>(r) * 6, finest_scale);
  // one sample per lane; the S * S lanes of a bin are neighbours
  for (int s0 = 0; s0 < P * SS; s0 += 32) {
    const int s = s0 + lane;
    const int px = s / SS;
    int o[4];
    float wt[4];
    const bool live = s < P * SS &&
                      sample_corners(g, py, px, (s / S) % S, s % S, P, S, o,
                                     wt);
    if (!live) {
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = -1, wt[k] = 0.f;
    }
    bool fits = false;
    int y0 = 0, x0 = 0;
    if (merge) {
      // the bin's corners: its rows y0..y1 and columns x0..x1
      const int ylo = live ? o[0] / g.W : INT_MAX;
      const int xlo = live ? o[0] - ylo * g.W : INT_MAX;
      const int yhi = live ? o[3] / g.W : INT_MIN;
      const int xhi = live ? o[3] - yhi * g.W : INT_MIN;
      y0 = ylo, x0 = xlo;
      int y1 = yhi, x1 = xhi;
#pragma unroll
      for (int m = 1; m < SS; m <<= 1) {
        y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, m));
        x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, m));
        y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, m));
        x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, m));
      }
      fits = y1 >= y0 && y1 - y0 < 3 && x1 - x0 < 3;
      // this sample's weights on the 3 x 3 window at (y0, x0), added over
      // the bin's samples in a fixed order (every lane takes part in the
      // shuffles; only a bin that fits uses the result)
      const int yy[4] = {ylo, ylo, yhi, yhi};
      const int xx[4] = {xlo, xhi, xlo, xhi};
      float w9[MERGED];
#pragma unroll
      for (int e = 0; e < MERGED; ++e) {
        w9[e] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (live && (yy[k] - y0) * 3 + xx[k] - x0 == e) w9[e] += wt[k];
      }
#pragma unroll
      for (int m = 1; m < SS; m <<= 1)
#pragma unroll
        for (int e = 0; e < MERGED; ++e)
          w9[e] += __shfl_xor_sync(0xffffffffu, w9[e], m);
      if (fits) {
        // lane j of the bin writes entries 4j .. 4j + 3 of the bin's table
        const int j = s % SS;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * j + k;
          float w = 0.f;
#pragma unroll
          for (int f = 0; f < MERGED; ++f)
            if (e == f) w = w9[f];
          o[k] = e < MERGED && w != 0.f
                     ? (y0 + e / 3) * g.W + x0 + e % 3
                     : -1;
          wt[k] = e < MERGED ? w : 0.f;
        }
      }
    }
    if (s < P * SS) {
      *reinterpret_cast<int4*>(to_s + 4 * s) = make_int4(o[0], o[1], o[2],
                                                         o[3]);
      *reinterpret_cast<float4*>(tw_s + 4 * s) =
          make_float4(wt[0], wt[1], wt[2], wt[3]);
      if (s % SS == 0) cnt_s[px] = fits ? MERGED : CORNERS;
    }
  }
  __syncwarp();

  const T* feat = static_cast<const T*>(pyr.f[g.lvl]) + g.img * C;
  const float scale = 1.0f / static_cast<float>(SS);
  for (int px = 0; px < P; ++px) {
    T* o = out + ((static_cast<size_t>(r) * P + py) * P + px) * C;
    const int* ts = to_s + px * CORNERS;
    const float* ws = tw_s + px * CORNERS;
    if (merge && cnt_s[px] == MERGED)  // warp-uniform
      bin_sums<T, MERGED>(ts, ws, feat, C, lane, scale, o);
    else
      bin_sums<T, CORNERS>(ts, ws, feat, C, lane, scale, o);
  }
}

template <typename T, int S>
int launch(const Pyramid& pyr, int num_levels, int N, int C, const float* rois,
           const long long* order, int R, int P, float finest_scale,
           void* out, cudaStream_t stream) {
  const size_t smem = table_bytes(P, S);
  auto kernel = roi_rows_kernel<T, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tasks = static_cast<long long>(R) * P;
  const int blocks = static_cast<int>((tasks + WARPS - 1) / WARPS);
  kernel<<<blocks, THREADS, smem, stream>>>(pyr, num_levels, N, C, rois,
                                            order, R, P, finest_scale,
                                            static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_s(int S, const Pyramid& pyr, int num_levels, int N, int C,
             const float* rois, const long long* order, int R, int P,
             float finest_scale, void* out, cudaStream_t stream) {
  if (S == 1)
    return launch<T, 1>(pyr, num_levels, N, C, rois, order, R, P,
                        finest_scale, out, stream);
  if (S == 2)
    return launch<T, 2>(pyr, num_levels, N, C, rois, order, R, P,
                        finest_scale, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The order of K1's tasks: rois bucketed by (level, image, cell of CELL x
// CELL pixels of the level, cells row by row), so that warps that run
// together read neighbouring pixels and the L2 keeps them. One block: count
// per bucket, an exclusive scan, a scatter (the order within a bucket is
// whatever the atomics give; every roi's output is the same in any order).
constexpr int CELL = 16;
constexpr int ORDER_THREADS = 1024;

struct Buckets {
  int base[ROI_MAX_LEVELS];  // first bucket of each level
  int cx[ROI_MAX_LEVELS];    // cells per row of each level
  int cy[ROI_MAX_LEVELS];    // cells per column
};

__host__ inline Buckets make_buckets(const Pyramid& pyr, int num_levels,
                                     int N, int* total) {
  Buckets bk;
  int nb = 0;
  for (int l = 0; l < ROI_MAX_LEVELS; ++l) {
    bk.base[l] = nb;
    bk.cx[l] = (pyr.w[l] + CELL - 1) / CELL;
    bk.cy[l] = (pyr.h[l] + CELL - 1) / CELL;
    if (l < num_levels) nb += N * bk.cx[l] * bk.cy[l];
  }
  *total = nb;
  return bk;
}

__device__ __forceinline__ int roi_bucket(const Pyramid& pyr,
                                          const Buckets& bk, int num_levels,
                                          int N, const float* roi,
                                          float finest_scale) {
  // the level of roi_geom
  const int b = min(max(static_cast<int>(roi[0]), 0), N - 1);
  const float scale = sqrtf(fmaxf(roi[3] * roi[4], 1e-6f));
  const float lf = floorf(log2f(scale / finest_scale + 1e-6f));
  const int l = static_cast<int>(
      fminf(fmaxf(lf, 0.f), static_cast<float>(num_levels - 1)));
  const float inv = 1.0f / (pyr.stride[l] * CELL);
  const int x = min(max(static_cast<int>(floorf(roi[1] * inv)), 0),
                    bk.cx[l] - 1);
  const int y = min(max(static_cast<int>(floorf(roi[2] * inv)), 0),
                    bk.cy[l] - 1);
  return bk.base[l] + (b * bk.cy[l] + y) * bk.cx[l] + x;
}

__global__ void __launch_bounds__(ORDER_THREADS)
    roi_order_kernel(Pyramid pyr, Buckets bk, int num_levels, int N,
                     const float* __restrict__ rois, int R,
                     float finest_scale, int nb,
                     long long* __restrict__ order) {
  // nb counters, a total per warp, each roi's bucket
  extern __shared__ int cnt[];
  int* warp_sum = cnt + nb;
  int* bucket = warp_sum + 32;
  const int tid = threadIdx.x;
  for (int i = tid; i < nb; i += ORDER_THREADS) cnt[i] = 0;
  __syncthreads();
#pragma unroll 4
  for (int r = tid; r < R; r += ORDER_THREADS) {
    const int b = roi_bucket(pyr, bk, num_levels, N, rois + 6 * r,
                             finest_scale);
    bucket[r] = b;
    atomicAdd(&cnt[b], 1);
  }
  __syncthreads();
  // exclusive scan: thread t owns counters [t * per, (t + 1) * per)
  const int per = (nb + ORDER_THREADS - 1) / ORDER_THREADS;
  const int lo = min(tid * per, nb);
  const int hi = min(lo + per, nb);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += cnt[i];
  int incl = own;  // inclusive scan over the warp
  const int lane = tid & 31;
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, m);
    if (lane >= m) incl += v;
  }
  if (lane == 31) warp_sum[tid >> 5] = incl;
  __syncthreads();
  if (tid < 32) {  // scan of the 32 warp totals
    int w = warp_sum[tid];
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, m);
      if (tid >= m) w += v;
    }
    warp_sum[tid] = w;
  }
  __syncthreads();
  int run = incl - own + ((tid >> 5) > 0 ? warp_sum[(tid >> 5) - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = cnt[i];
    cnt[i] = run;
    run += c;
  }
  __syncthreads();
  for (int r = tid; r < R; r += ORDER_THREADS)
    order[atomicAdd(&cnt[bucket[r]], 1)] = r;
}

}  // namespace

// Shared memory of one block of the row design (8 warps) at P x P bins of
// S x S samples.
extern "C" size_t rs_roi_align_rows_smem_bytes(int P, int S) {
  return table_bytes(P, S);
}

// rs_roi_align_rotated_pyramid_fwd's arguments (roi_align_rotated.cu) through
// the row design, with `order` (int64 [R], a permutation of the rois: the
// order in which warps take them; null: as given) after `rois`: vec must be
// one 16-byte vector (4 for f32, 8 for bf16; C a multiple of it, 16-byte
// aligned levels and output), S 1 or 2, R * P below 2^31
// (ops/roi_align.py:k1_plan).
extern "C" int rs_roi_align_rotated_pyramid_fwd_rows(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int num_levels, int N, int C, int h0, int w0, int h1, int w1, int h2,
    int w2, int h3, int w3, float s0, float s1, float s2, float s3,
    const void* rois, const void* order, int R, int P, int S,
    float finest_scale, void* out, int dtype, int vec, void* stream) {
  if (num_levels < 1 || num_levels > ROI_MAX_LEVELS || N < 1 || C < 1 ||
      P < 1 || S < 1 || static_cast<long long>(R) * P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Pyramid pyr = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
                 {s0, s1, s2, s3}};
  const float* r = static_cast<const float*>(rois);
  const long long* ord = static_cast<const long long*>(order);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && C % 4 == 0)
    return launch_s<float>(S, pyr, num_levels, N, C, r, ord, R, P,
                           finest_scale, out, st);
  if (dtype == 1 && vec == 8 && C % 8 == 0)
    return launch_s<__nv_bfloat16>(S, pyr, num_levels, N, C, r, ord, R, P,
                                   finest_scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Buckets of the row design's order at these levels (level, image, cell of
// 16 x 16 pixels), and the order itself: order [R] int64, the roi indices
// bucket by bucket (ops/roi_align.py:k1_buckets is its plain version). One
// block, (buckets + 32 + R) * 4 bytes of shared memory.
extern "C" int rs_roi_align_rows_buckets(int num_levels, int N, int h0,
                                         int w0, int h1, int w1, int h2,
                                         int w2, int h3, int w3) {
  Pyramid pyr = {{nullptr, nullptr, nullptr, nullptr},
                 {h0, h1, h2, h3},
                 {w0, w1, w2, w3},
                 {1.f, 1.f, 1.f, 1.f}};
  int nb = 0;
  make_buckets(pyr, num_levels, N, &nb);
  return nb;
}

extern "C" int rs_roi_align_rows_order(int num_levels, int N, int h0, int w0,
                                       int h1, int w1, int h2, int w2, int h3,
                                       int w3, float s0, float s1, float s2,
                                       float s3, const void* rois, int R,
                                       float finest_scale, void* order,
                                       void* stream) {
  if (num_levels < 1 || num_levels > ROI_MAX_LEVELS || N < 1 || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Pyramid pyr = {{nullptr, nullptr, nullptr, nullptr},
                 {h0, h1, h2, h3},
                 {w0, w1, w2, w3},
                 {s0, s1, s2, s3}};
  int nb = 0;
  const Buckets bk = make_buckets(pyr, num_levels, N, &nb);
  const size_t smem = (static_cast<size_t>(nb) + 32 + R) * sizeof(int);
  if (smem > static_cast<size_t>(smem_optin_limit()))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      roi_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  roi_order_kernel<<<1, ORDER_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      pyr, bk, num_levels, N, static_cast<const float*>(rois), R,
      finest_scale, nb, static_cast<long long*>(order));
  return static_cast<int>(cudaGetLastError());
}
