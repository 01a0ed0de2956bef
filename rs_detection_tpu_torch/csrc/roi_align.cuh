// What the rotated pyramid RoIAlign kernels share: the pyramid's levels, a
// roi's level and sampling frame, the bilinear corners of one sample, and
// VEC-channel loads and stores. The forward (K1) and both designs of the
// backward (K3) include it, so their geometry cannot drift apart.

#pragma once

#include <stddef.h>

#include "rs_common.cuh"

namespace rs {

constexpr int ROI_MAX_LEVELS = 4;

struct Pyramid {
  const void* f[ROI_MAX_LEVELS];
  int h[ROI_MAX_LEVELS];
  int w[ROI_MAX_LEVELS];
  float stride[ROI_MAX_LEVELS];
};

// VEC channels per lane: one 16-byte load (VEC = 16 / sizeof(T)) or scalar.
template <typename T, int VEC> struct Vec;

template <typename T> struct Vec<T, 1> {
  static __device__ __forceinline__ void fma(const T* p, float w, float* a) {
    a[0] += w * to_f(p[0]);
  }
  static __device__ __forceinline__ void load(const T* p, float* a) {
    a[0] = to_f(p[0]);
  }
  static __device__ __forceinline__ void store(T* p, const float* a) {
    p[0] = from_f<T>(a[0]);
  }
};

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void fma(const float* p, float w,
                                             float* a) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a[0] += w * q.x;
    a[1] += w * q.y;
    a[2] += w * q.z;
    a[3] += w * q.w;
  }
  static __device__ __forceinline__ void load(const float* p, float* a) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a[0] = q.x;
    a[1] = q.y;
    a[2] = q.z;
    a[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* a) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void fma(const __nv_bfloat16* p, float w,
                                             float* a) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      a[2 * i] += w * f.x;
      a[2 * i + 1] += w * f.y;
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* a) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* a) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// A roi's level and its sampling frame on that level.
struct RoiGeom {
  int lvl, H, W;
  size_t img;  // first pixel of the roi's image in its level: b * H * W
  float cx, cy, rw, rh, ct, st;
};

__device__ __forceinline__ RoiGeom roi_geom(const Pyramid& pyr,
                                            int num_levels, int N,
                                            const float* roi,
                                            float finest_scale) {
  RoiGeom q;
  // a batch index outside [0, N) is clamped (the XLA gather clamps too)
  const int b = min(max(static_cast<int>(roi[0]), 0), N - 1);
  const float w0 = roi[3];
  const float h0 = roi[4];
  const float scale = sqrtf(fmaxf(w0 * h0, 1e-6f));
  const float lf = floorf(log2f(scale / finest_scale + 1e-6f));
  q.lvl = static_cast<int>(
      fminf(fmaxf(lf, 0.f), static_cast<float>(num_levels - 1)));
  q.H = pyr.h[q.lvl];
  q.W = pyr.w[q.lvl];
  const float inv = 1.0f / pyr.stride[q.lvl];
  q.cx = roi[1] * inv - 0.5f;
  q.cy = roi[2] * inv - 0.5f;
  q.rw = fmaxf(w0 * inv, 1.0f);
  q.rh = fmaxf(h0 * inv, 1.0f);
  q.ct = cosf(roi[5]);
  q.st = sinf(roi[5]);
  q.img = static_cast<size_t>(b) * q.H * q.W;
  return q;
}

// Sample (iy, ix) of bin (py, px): the pixel index (y * W + x, within the
// roi's image) and bilinear weight of each of its 4 corners. False for a
// sample outside the border band, which contributes nothing.
__device__ __forceinline__ bool sample_corners(const RoiGeom& q, int py,
                                               int px, int iy, int ix, int P,
                                               int S, int (&o)[4],
                                               float (&wt)[4]) {
  const float yy = ((py + (iy + 0.5f) / S) / P - 0.5f) * q.rh;
  const float xx = ((px + (ix + 0.5f) / S) / P - 0.5f) * q.rw;
  float x = xx * q.ct + yy * q.st + q.cx;
  float y = yy * q.ct - xx * q.st + q.cy;
  if (y < -1.0f || y > q.H || x < -1.0f || x > q.W) return false;
  y = fmaxf(y, 0.f);
  x = fmaxf(x, 0.f);
  int y_lo = static_cast<int>(y);
  int x_lo = static_cast<int>(x);
  int y_hi, x_hi;
  if (y_lo >= q.H - 1) {
    y_lo = y_hi = q.H - 1;
    y = static_cast<float>(y_lo);
  } else {
    y_hi = y_lo + 1;
  }
  if (x_lo >= q.W - 1) {
    x_lo = x_hi = q.W - 1;
    x = static_cast<float>(x_lo);
  } else {
    x_hi = x_lo + 1;
  }
  const float ly = y - y_lo;
  const float lx = x - x_lo;
  const float hy = 1.f - ly;
  const float hx = 1.f - lx;
  o[0] = y_lo * q.W + x_lo;
  o[1] = y_lo * q.W + x_hi;
  o[2] = y_hi * q.W + x_lo;
  o[3] = y_hi * q.W + x_hi;
  wt[0] = hy * hx;
  wt[1] = hy * lx;
  wt[2] = ly * hx;
  wt[3] = ly * lx;
  return true;
}

}  // namespace rs
