// The rotated pyramid RoIAlign backward (K3) for Hopper (sm_90a), ordered by
// destination: a gather with no atomics.
//
// Replaces: rs_detection_tpu/ops/pallas_roi_align.py, `_scatter_kernel`
// (reached through `_pyramid_pallas_bwd_impl`), which also adds in a fixed
// order. It computes d_feats[l] = sum over the level's rois of A^T g, the
// exact adjoint of K1 (roi_align_rotated.cu), through the same `roi_geom` /
// `sample_corners` code (roi_align.cuh).
//
// What bounded the first design (roi_align_rotated.cu, the atomic form) on
// the H100: 4 corners x C f32 atomics per live sample into a zeroed f32
// scratch pyramid, serialized in the L2 where rois overlap (a step's
// positives cluster around the ground truths), then a pass that casts the
// scratch: 713 MB of f32 zeroed, read and cast to 357 MB of bf16 at the
// training shape. This design moves each output byte once:
//   1. records (`roi_bwd_records_kernel`): one thread per (roi, bin, sample)
//      writes its 4 corners as records, in (roi, bin, sample, corner) order:
//      the destination pixel as one int over the whole pyramid (level offset
//      + b * H * W + y * W + x) and the bilinear weight / S^2. A sample
//      outside the border band writes 4 dead records (destination = the
//      pixel count, weight 0); a clamped sample whose corners coincide
//      writes two records for one pixel, as the adjoint needs. The record's
//      index carries its source row of g: index / (4 * S * S) = r * P * P +
//      bin.
//   2. order (the wrapper, ops/roi_align.py): a stable sort of the records
//      by destination and each pixel's first record (searchsorted), where
//      the JAX wrapper sorts its addresses with `jnp.argsort` outside the
//      kernel body too.
//   3. sum (`roi_bwd_gather_kernel`): one warp per pixel of the pyramid.
//      The warp reads its run's records 32 at a time (one per lane), passes
//      each (row, weight) round by a shuffle, and each lane adds its 16
//      bytes of the g row (8 bf16 or 4 f32 channels; one channel where C is
//      no multiple of those or g's rows are not 16-byte aligned) in f32, in
//      the sorted order; then it writes the pixel's row once in the features' dtype
//      (zeros for a pixel with no record). No memset, no scratch, no cast
//      pass, and the same bits on every run.
// Bytes at the training shape (4096 rois, C = 256, bf16): ~3.2 M records
// (13 MB of keys, 13 MB of weights, a 26 MB permutation), g 103 MB read ~16
// times through the records (1.6 GB of 512-byte rows, partly from the L2),
// 357 MB written once.

#include <stdint.h>

#include "roi_align.cuh"

namespace {

using namespace rs;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// First pixel of each level in the pyramid-wide numbering; off[num_levels]
// is the pixel count.
struct LevelOffsets {
  int off[ROI_MAX_LEVELS + 1];
};

LevelOffsets level_offsets(int num_levels, int N, const int* h,
                           const int* w) {
  LevelOffsets o = {};
  for (int l = 0; l < num_levels; ++l)
    o.off[l + 1] = o.off[l] + N * h[l] * w[l];
  for (int l = num_levels + 1; l <= ROI_MAX_LEVELS; ++l)
    o.off[l] = o.off[num_levels];
  return o;
}

__global__ void __launch_bounds__(THREADS)
    roi_bwd_records_kernel(Pyramid pyr, LevelOffsets lo, int num_levels,
                           int N, const float* __restrict__ rois, int R,
                           int P, int S, float finest_scale,
                           int* __restrict__ keys, float* __restrict__ wts) {
  const int ss = S * S;
  const int per_roi = P * P * ss;
  const long long idx =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= static_cast<long long>(R) * per_roi) return;
  const int r = static_cast<int>(idx / per_roi);
  const int rem = static_cast<int>(idx - static_cast<long long>(r) * per_roi);
  const int bin = rem / ss;
  const int smp = rem - bin * ss;
  const int py = bin / P;
  const int px = bin - py * P;
  const int iy = smp / S;
  const int ix = smp - iy * S;
  const RoiGeom q = roi_geom(pyr, num_levels, N,
                             rois + static_cast<size_t>(r) * 6, finest_scale);
  int o[4];
  float wt[4];
  int4 k = make_int4(lo.off[num_levels], lo.off[num_levels],
                     lo.off[num_levels], lo.off[num_levels]);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sample_corners(q, py, px, iy, ix, P, S, o, wt)) {
    const int base = lo.off[q.lvl] + static_cast<int>(q.img);
    const float inv_count = 1.0f / static_cast<float>(ss);
    k = make_int4(base + o[0], base + o[1], base + o[2], base + o[3]);
    v = make_float4(wt[0] * inv_count, wt[1] * inv_count, wt[2] * inv_count,
                    wt[3] * inv_count);
  }
  reinterpret_cast<int4*>(keys)[idx] = k;
  reinterpret_cast<float4*>(wts)[idx] = v;
}

template <typename T> struct Outs {
  T* o[ROI_MAX_LEVELS];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    roi_bwd_gather_kernel(const T* __restrict__ g,
                          const long long* __restrict__ perm,
                          const float* __restrict__ wts,
                          const int* __restrict__ starts, LevelOffsets lo,
                          int num_levels, int C, int rec_per_row,
                          Outs<T> outs) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= lo.off[num_levels]) return;  // warp-uniform
  int l = 0;
  while (l + 1 < num_levels && p >= lo.off[l + 1]) ++l;
  T* out = outs.o[l] + static_cast<size_t>(p - lo.off[l]) * C;
  const int s = starts[p];
  const int e = starts[p + 1];
  const int ngroups = C / VEC;
  for (int base = 0; base < ngroups; base += 32) {
    const int grp = base + lane;
    const bool active = grp < ngroups;
    const T* gcol = g + grp * VEC;
    float a[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] = 0.f;
    for (int j0 = s; j0 < e; j0 += 32) {
      const int n = min(32, e - j0);
      int row = 0;
      float w = 0.f;
      if (lane < n) {
        const long long rec = perm[j0 + lane];
        row = static_cast<int>(rec / rec_per_row);
        w = wts[rec];
      }
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int ri = __shfl_sync(0xffffffffu, row, i);
        const float wi = __shfl_sync(0xffffffffu, w, i);
        if (active)
          Vec<T, VEC>::fma(gcol + static_cast<size_t>(ri) * C, wi, a);
      }
    }
    if (active) Vec<T, VEC>::store(out + grp * VEC, a);
  }
}

template <typename T, int VEC>
int launch_gather(const void* g, const void* perm, const void* wts,
                  const void* starts, const LevelOffsets& lo, int num_levels,
                  int C, int rec_per_row, void* const* outs,
                  cudaStream_t stream) {
  Outs<T> o = {};
  for (int l = 0; l < num_levels; ++l) o.o[l] = static_cast<T*>(outs[l]);
  const int pixels = lo.off[num_levels];
  roi_bwd_gather_kernel<T, VEC>
      <<<(pixels + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const long long*>(perm),
          static_cast<const float*>(wts), static_cast<const int*>(starts), lo,
          num_levels, C, rec_per_row, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Step 1: the records of the rois' samples. keys (int32) and wts (f32) hold
// R * P * P * S * S * 4 entries each, 16-byte aligned; a dead record's key is
// the pyramid's pixel count (sum over levels of N * h_l * w_l, below 2^31).
// Roi, level and stride arguments as rs_roi_align_rotated_pyramid_fwd.
extern "C" int rs_roi_align_rotated_pyramid_bwd_records(
    int num_levels, int N, int h0, int w0, int h1, int w1, int h2, int w2,
    int h3, int w3, float s0, float s1, float s2, float s3, const void* rois,
    int R, int P, int S, float finest_scale, void* keys, void* wts,
    void* stream) {
  if (num_levels < 1 || num_levels > ROI_MAX_LEVELS || N < 1 || P < 1 ||
      S < 1 || R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(R) * P * P * S * S;
  if (n == 0) return 0;
  const Pyramid pyr = {{nullptr, nullptr, nullptr, nullptr},
                       {h0, h1, h2, h3},
                       {w0, w1, w2, w3},
                       {s0, s1, s2, s3}};
  const LevelOffsets lo = level_offsets(num_levels, N, pyr.h, pyr.w);
  roi_bwd_records_kernel<<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                           THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      pyr, lo, num_levels, N, static_cast<const float*>(rois), R, P, S,
      finest_scale, static_cast<int*>(keys), static_cast<float*>(wts));
  return static_cast<int>(cudaGetLastError());
}

// Step 3: the sums. g [R, P, P, C] in `dtype` (0 = f32, 1 = bf16); vec: 1,
// or 16 / element size with C % vec == 0 and g 16-byte aligned; perm
// (int64): the records' indices in stable destination order; wts: the
// records' weights;
// starts (int32, pixel count + 1): the first sorted record of each pixel;
// rec_per_row = 4 * S * S; o0..o3: the per-level outputs [N, h_l, w_l, C] in
// `dtype`, every element written. Returns cudaGetLastError().
extern "C" int rs_roi_align_rotated_pyramid_bwd_gather(
    const void* g, const void* perm, const void* wts, const void* starts,
    int num_levels, int N, int C, int h0, int w0, int h1, int w1, int h2,
    int w2, int h3, int w3, int rec_per_row, void* o0, void* o1, void* o2,
    void* o3, int dtype, int vec, void* stream) {
  if (num_levels < 1 || num_levels > ROI_MAX_LEVELS || N < 1 || C < 1 ||
      rec_per_row < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h[ROI_MAX_LEVELS] = {h0, h1, h2, h3};
  const int w[ROI_MAX_LEVELS] = {w0, w1, w2, w3};
  const LevelOffsets lo = level_offsets(num_levels, N, h, w);
  void* const outs[ROI_MAX_LEVELS] = {o0, o1, o2, o3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && C % 4 == 0)
    return launch_gather<float, 4>(g, perm, wts, starts, lo, num_levels, C,
                                   rec_per_row, outs, st);
  if (dtype == 1 && vec == 8 && C % 8 == 0)
    return launch_gather<__nv_bfloat16, 8>(g, perm, wts, starts, lo,
                                           num_levels, C, rec_per_row, outs,
                                           st);
  if (dtype == 0 && vec == 1)
    return launch_gather<float, 1>(g, perm, wts, starts, lo, num_levels, C,
                                   rec_per_row, outs, st);
  if (dtype == 1 && vec == 1)
    return launch_gather<__nv_bfloat16, 1>(g, perm, wts, starts, lo,
                                           num_levels, C, rec_per_row, outs,
                                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
