// Rotated RoIAlign over an FPN pyramid, forward (K1) and the first design of
// the backward (K3), for Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_roi_align.py, `_pool_kernel` (K1,
// reached through `roi_align_rotated_pyramid_pallas`) and `_scatter_kernel`
// (K3, reached through `_pallas_bwd` / `_pyramid_pallas_bwd_impl`), the RoI
// stage of Oriented R-CNN. The forward computes the exact function of
// rs_detection_tpu/ops/roi_align.py:roi_align_rotated_pyramid for every roi:
//   level  = clip(floor(log2(sqrt(max(w*h, 1e-6)) / finest + 1e-6)), 0, L-1)
//   grid   = P x P bins x S x S samples at c/stride - 0.5 on the rotated
//            box, rw = max(w/stride, 1), rh = max(h/stride, 1)
//   sample = bilinear with the reference border rules: 0 when y < -1,
//            y > H, x < -1 or x > W; otherwise clamp at 0, and a low index
//            at or past the last row/column takes that row/column with zero
//            fraction
//   out    = mean of the S*S samples of each bin, [R, P, P, C]
// and the backward its exact adjoint, d_feats[l] = sum over the level's rois
// of A^T g. Every kernel goes through `roi_geom` / `sample_corners`
// (roi_align.cuh), so they cannot drift apart. None of the TPU kernels' window
// tiers, u8 interpolation matrix, address sort or XLA fallback tail (which
// clamps oversize rois to a window) is needed: a GPU thread reads and adds to
// any address.
//
// What bounds the forward on the H100: gathers. At 16000 rois, C = 256,
// bf16 it reads 16000 * 49 * 4 samples * 4 corners * 512 bytes (~6.4 GB of
// corner rows, most of them hits in the 50 MB L2 because neighbouring samples
// share corners) and writes 400 MB. One block per roi; each warp owns one
// bin at a time and each lane 8 channels, so every corner read is one 16-byte
// load per lane and 512 contiguous bytes per warp. Sums are f32 and the
// result is stored once in the features' dtype.
//
// The backward's first design, the atomic form, has the same shape with
// atomics in place of loads: one block per roi, one warp per bin, each lane
// 8 (bf16) or 4 (f32) channels, and for every live sample 4 corners x VEC
// f32 atomicAdds into an f32 scratch pyramid (a clamped sample whose corners
// coincide adds twice, as the adjoint must). At the training shape (4096
// rois, C = 256) that is ~820 M f32 atomics, bound by the L2's atomic rate
// and serialized where rois overlap; the scratch is then cast once to the
// features' dtype. Atomics make the low bits run-dependent. The backward
// runs the destination-ordered design of roi_align_rotated_bwd.cu at every
// shape; this one stays as the reference that design is timed against
// (ops/roi_align.py:roi_align_rotated_pyramid_bwd_first_design).

#include <stdint.h>

#include <algorithm>

#include "roi_align.cuh"

namespace {

using namespace rs;

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = ROI_MAX_LEVELS;

struct GradPyramid {
  float* d[MAX_LEVELS];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    roi_align_rotated_pyramid_kernel(Pyramid pyr, int num_levels, int N,
                                     int C, const float* __restrict__ rois,
                                     int P, int S, float finest_scale,
                                     T* __restrict__ out) {
  const int r = blockIdx.x;
  const RoiGeom q = roi_geom(pyr, num_levels, N,
                             rois + static_cast<size_t>(r) * 6, finest_scale);
  const T* feat = static_cast<const T*>(pyr.f[q.lvl]) + q.img * C;
  const float inv_count = 1.0f / static_cast<float>(S * S);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ngroups = C / VEC;

  for (int bin = warp; bin < P * P; bin += THREADS / 32) {
    const int py = bin / P;
    const int px = bin - py * P;
    for (int g = lane; g < ngroups; g += 32) {
      const int c0 = g * VEC;
      float a[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) a[v] = 0.f;
      for (int iy = 0; iy < S; ++iy) {
        for (int ix = 0; ix < S; ++ix) {
          int o[4];
          float wt[4];
          if (!sample_corners(q, py, px, iy, ix, P, S, o, wt)) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            Vec<T, VEC>::fma(feat + static_cast<size_t>(o[k]) * C + c0,
                             wt[k], a);
        }
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) a[v] *= inv_count;
      Vec<T, VEC>::store(
          out + ((static_cast<size_t>(r) * P + py) * P + px) * C + c0, a);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
    roi_align_rotated_pyramid_bwd_kernel(Pyramid pyr, GradPyramid grad,
                                         int num_levels, int N, int C,
                                         const float* __restrict__ rois,
                                         int P, int S, float finest_scale,
                                         const T* __restrict__ g) {
  const int r = blockIdx.x;
  const RoiGeom q = roi_geom(pyr, num_levels, N,
                             rois + static_cast<size_t>(r) * 6, finest_scale);
  float* d = grad.d[q.lvl] + q.img * C;
  const float inv_count = 1.0f / static_cast<float>(S * S);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ngroups = C / VEC;

  for (int bin = warp; bin < P * P; bin += THREADS / 32) {
    const int py = bin / P;
    const int px = bin - py * P;
    for (int grp = lane; grp < ngroups; grp += 32) {
      const int c0 = grp * VEC;
      float gv[VEC];
      Vec<T, VEC>::load(
          g + ((static_cast<size_t>(r) * P + py) * P + px) * C + c0, gv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) gv[v] *= inv_count;
      for (int iy = 0; iy < S; ++iy) {
        for (int ix = 0; ix < S; ++ix) {
          int o[4];
          float wt[4];
          if (!sample_corners(q, py, px, iy, ix, P, S, o, wt)) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float* p = d + static_cast<size_t>(o[k]) * C + c0;
#pragma unroll
            for (int v = 0; v < VEC; ++v) atomicAdd(p + v, wt[k] * gv[v]);
          }
        }
      }
    }
  }
}

__global__ void f32_to_bf16_kernel(const float* __restrict__ in,
                                   __nv_bfloat16* __restrict__ out,
                                   size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[i] = __float2bfloat16(in[i]);
}

template <typename T, int VEC>
int launch(const Pyramid& pyr, int num_levels, int N, int C, const float* rois,
           int R, int P, int S, float finest_scale, void* out,
           cudaStream_t stream) {
  roi_align_rotated_pyramid_kernel<T, VEC><<<R, THREADS, 0, stream>>>(
      pyr, num_levels, N, C, rois, P, S, finest_scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_bwd(const Pyramid& pyr, const GradPyramid& grad, int num_levels,
               int N, int C, const float* rois, int R, int P, int S,
               float finest_scale, const void* g, cudaStream_t stream) {
  roi_align_rotated_pyramid_bwd_kernel<T, VEC><<<R, THREADS, 0, stream>>>(
      pyr, grad, num_levels, N, C, rois, P, S, finest_scale,
      static_cast<const T*>(g));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats f0..f3: per-level [N, h_l, w_l, C] contiguous NHWC (unused levels may
// be null); rois [R, 6] f32 (b, cx, cy, w, h, theta) with w/h already
// inflated; out [R, P, P, C]. dtype: 0 = f32, 1 = bf16. vec: 1, or 16 bytes
// per lane (4 for f32, 8 for bf16; needs C % vec == 0 and 16-byte aligned
// rows). Launches on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int rs_roi_align_rotated_pyramid_fwd(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int num_levels, int N, int C, int h0, int w0, int h1, int w1, int h2,
    int w2, int h3, int w3, float s0, float s1, float s2, float s3,
    const void* rois, int R, int P, int S, float finest_scale, void* out,
    int dtype, int vec, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || N < 1 || C < 1 || P < 1 ||
      S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Pyramid pyr = {{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
                 {s0, s1, s2, s3}};
  const float* r = static_cast<const float*>(rois);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(pyr, num_levels, N, C, r, R, P, S, finest_scale,
                            out, st);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(pyr, num_levels, N, C, r, R, P, S, finest_scale,
                            out, st);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(pyr, num_levels, N, C, r, R, P, S,
                                    finest_scale, out, st);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(pyr, num_levels, N, C, r, R, P, S,
                                    finest_scale, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The adjoint of rs_roi_align_rotated_pyramid_fwd with the same roi, level
// and dtype arguments. g: [R, P, P, C] contiguous in `dtype`. d0..d3: per
// level [N, h_l, w_l, C] f32 scratch, zeroed by the caller, that receives the
// sums. o0..o3: per-level outputs in `dtype`; for bf16 each scratch level is
// cast into them, for f32 the scratch is the output and they are ignored.
// vec as in the forward (C % vec == 0, 16-byte aligned g rows).
extern "C" int rs_roi_align_rotated_pyramid_bwd(
    const void* g, int num_levels, int N, int C, int h0, int w0, int h1,
    int w1, int h2, int w2, int h3, int w3, float s0, float s1, float s2,
    float s3, const void* rois, int R, int P, int S, float finest_scale,
    void* d0, void* d1, void* d2, void* d3, void* o0, void* o1, void* o2,
    void* o3, int dtype, int vec, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || N < 1 || C < 1 || P < 1 ||
      S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Pyramid pyr = {{nullptr, nullptr, nullptr, nullptr},
                 {h0, h1, h2, h3},
                 {w0, w1, w2, w3},
                 {s0, s1, s2, s3}};
  GradPyramid grad = {{static_cast<float*>(d0), static_cast<float*>(d1),
                       static_cast<float*>(d2), static_cast<float*>(d3)}};
  const float* r = static_cast<const float*>(rois);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (R == 0)
    err = 0;
  else if (dtype == 0 && vec == 4)
    err = launch_bwd<float, 4>(pyr, grad, num_levels, N, C, r, R, P, S,
                               finest_scale, g, st);
  else if (dtype == 0 && vec == 1)
    err = launch_bwd<float, 1>(pyr, grad, num_levels, N, C, r, R, P, S,
                               finest_scale, g, st);
  else if (dtype == 1 && vec == 8)
    err = launch_bwd<__nv_bfloat16, 8>(pyr, grad, num_levels, N, C, r, R, P,
                                       S, finest_scale, g, st);
  else if (dtype == 1 && vec == 1)
    err = launch_bwd<__nv_bfloat16, 1>(pyr, grad, num_levels, N, C, r, R, P,
                                       S, finest_scale, g, st);
  if (err != 0 || dtype == 0) return err;
  void* outs[MAX_LEVELS] = {o0, o1, o2, o3};
  for (int l = 0; l < num_levels; ++l) {
    const size_t n = static_cast<size_t>(N) * pyr.h[l] * pyr.w[l] * C;
    const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
    f32_to_bf16_kernel<<<blocks, 256, 0, st>>>(
        grad.d[l], static_cast<__nv_bfloat16*>(outs[l]), n);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}
