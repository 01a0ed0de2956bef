// Depthwise K x K dilated convolution forward (K5, and K7's layout) for
// Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_dwconv.py, `_dw_kernel` (reached
// through `depthwise_conv2d`), and the same function in the prototype's
// layout, tools/analysis_tools/chw_dw_proto.py, `_dw_kernel` (reached through
// `dw_chw`). It also runs the two depthwise convs in the middle of the fused
// VAN attention half-block (ops/van_attn.py), with their biases.
//
// Computes, at stride 1 with SAME zero padding p = d * (K - 1) / 2,
//   y[n, r, q, c] = bias[c] + sum_{ky,kx} xpad[n, r + ky*d, q + kx*d, c]
//                                         * w[ky*K + kx, c]
// with the taps summed in f32 and one rounding to the output dtype
// (pallas_dwconv.py:49-59). One kernel template serves two memory layouts:
//   NHWC  x [N, H, W, C]   a lane owns a channel, a warp walks pixels;
//   HCW   x [N, H, C, W]   a lane owns a column, a warp owns a channel.
// The taps are addressed through two element strides, so `w` may be [K*K, C]
// (the JAX op) or [C, K*K] (nn.Conv2d and the prototype).
//
// What bounds it on the H100: in HBM terms it reads x and writes y once (134
// MB at [8, 256, 256, 64] bf16, 0.04 ms), but each output takes K*K
// multiply-adds whose x operand comes from shared memory, so the limit is the
// SM's shared-memory load rate, not bandwidth. The design: a block stages the
// haloed x tile in shared memory once for all K*K taps (16-byte cp.async
// vectors in NHWC), keeps its channel's K*K weights in registers, and each
// thread produces R outputs spaced one dilation apart along the rows, so one
// loaded value feeds up to R taps: (R + K - 1) * K loads for R * K * K
// multiply-adds (2.8 x fewer at K = 7, R = 4). The wrapper picks R = 4 at
// K = 5 and 7 and R = 1 at K = 3, where 4 measured slower.
//
// This is the first design of both layouts. K5 runs the streaming design of
// dw_conv_fwd_stream.cu for bf16 NHWC at VAN's (5, 1) and (7, 3), and K7's
// form the row-streaming design of dw_conv_chw.cu for bf16 [N, H, C, W]
// with W a multiple of 8 at dilation 1-3 (ops/dwconv.py:dw_plan). This one
// runs every other shape and stays as the reference both are timed against
// (depthwise_conv2d_first_design, dw_chw_first_design).

#include <stdint.h>

#include "rs_common.cuh"

namespace {

using namespace rs;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Tile geometry of a layout: CT channels x TW columns per block; the tile's
// rows are R * d * m (m groups of d interleaved row sets).
template <bool HCW> struct Geom {
  static constexpr int CT = HCW ? WARPS : 32;
  static constexpr int TW = HCW ? 32 : 16;
};

__host__ __device__ inline int groups_m(int R, int d) {
  const int m = 16 / (R * d);
  return m < 1 ? 1 : m;
}

template <typename T, bool HCW>
__host__ __device__ inline size_t smem_bytes(int K, int R, int d) {
  const int halo = (K - 1) * d;
  const int th = R * d * groups_m(R, d);
  return static_cast<size_t>(th + halo) * (Geom<HCW>::TW + halo) *
         Geom<HCW>::CT * sizeof(T);
}

// The R outputs at rows {j * rs} of one column and channel: `xs` points at
// the first output's top-left tap; rs / cs are the shared-memory strides of
// one dilation step down / right. Input row j feeds output i with tap row
// j - i.
template <typename T, int K, int R>
__device__ __forceinline__ void taps(const T* xs, int rs, int cs,
                                     const float (&w)[K * K],
                                     float (&acc)[R]) {
#pragma unroll
  for (int kx = 0; kx < K; ++kx) {
#pragma unroll
    for (int j = 0; j < R + K - 1; ++j) {
      const float v = to_f(xs[j * rs + kx * cs]);
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (j - i >= 0 && j - i < K) acc[i] += v * w[(j - i) * K + kx];
    }
  }
}

template <typename T, int K, int R, bool HCW>
__global__ void __launch_bounds__(THREADS)
    dw_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ y, int H, int W,
                  int C, int d, long long w_tap, long long w_ch, int tiles_x,
                  int vec_ok) {
  constexpr int CT = Geom<HCW>::CT;
  constexpr int TW = Geom<HCW>::TW;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int halo = (K - 1) * d;
  const int pad = halo / 2;
  const int ngroups = d * groups_m(R, d);  // row sets of R rows each
  const int th = R * ngroups;
  const int rh = th + halo;
  const int rw = TW + halo;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * CT;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t img = static_cast<size_t>(n) * H * W * C;

  // stage the haloed tile, zero outside the image and past C:
  //   NHWC -> xs[row][col][CT],  HCW -> xs[row][CT][col]
  if (!HCW && vec_ok) {
    constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector
    constexpr int VPP = CT / VE;        // vectors per pixel
    copy_vec16(
        rh * rw * VPP, x,
        [&](int i) -> const T* {
          const int pix = i / VPP;
          const int gy = y0 - pad + pix / rw;
          const int gx = x0 - pad + pix % rw;
          const int c = c0 + (i - pix * VPP) * VE;
          if (gy < 0 || gy >= H || gx < 0 || gx >= W || c >= C) return nullptr;
          return x + img + (static_cast<size_t>(gy) * W + gx) * C + c;
        },
        [&](int i) { return xs + static_cast<size_t>(i) * VE; });
    cp_async_wait_all();
  } else {
    const int total = rh * rw * CT;
    for (int i = threadIdx.x; i < total; i += THREADS) {
      int row, col, c;
      if (HCW) {
        col = i % rw;
        c = (i / rw) % CT;
        row = i / (rw * CT);
      } else {
        c = i % CT;
        col = (i / CT) % rw;
        row = i / (CT * rw);
      }
      const int gy = y0 - pad + row;
      const int gx = x0 - pad + col;
      T v = from_f<T>(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C)
        v = HCW ? x[img + (static_cast<size_t>(gy) * C + c0 + c) * W + gx]
                : x[img + (static_cast<size_t>(gy) * W + gx) * C + c0 + c];
      xs[i] = v;
    }
  }

  // this thread's channel: its taps and bias in registers
  const int c = c0 + (HCW ? warp : lane);
  float wr[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wr[t] = c < C ? to_f(w[t * w_tap + c * w_ch]) : 0.f;
  const float bv = (bias != nullptr && c < C) ? to_f(bias[c]) : 0.f;
  __syncthreads();

  // shared-memory strides of one pixel down / right
  const int s_row = rw * CT;
  const int s_col = HCW ? 1 : CT;
  // a row set g holds rows (g / d) * R * d + g % d + i * d, i < R
  const int items = HCW ? ngroups : ngroups * TW;
  for (int it = HCW ? 0 : warp; it < items; it += HCW ? 1 : WARPS) {
    const int g = HCW ? it : it / TW;
    const int col = HCW ? lane : it % TW;
    const int r0 = (g / d) * R * d + g % d;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = bv;
    const T* base = xs + r0 * s_row + col * s_col +
                    (HCW ? warp * rw : lane);
    taps<T, K, R>(base, d * s_row, d * s_col, wr, acc);
    const int gx = x0 + col;
    if (gx >= W || c >= C) continue;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int gy = y0 + r0 + i * d;
      if (gy >= H) continue;
      const size_t o = HCW ? (static_cast<size_t>(gy) * C + c) * W + gx
                           : (static_cast<size_t>(gy) * W + gx) * C + c;
      y[img + o] = from_f<T>(acc[i]);
    }
  }
}

template <typename T, int K, int R, bool HCW>
int launch(const void* x, const void* w, const void* bias, void* y, int N,
           int H, int W, int C, int d, long long w_tap, long long w_ch,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HCW>(K, R, d);
  if (smem > static_cast<size_t>(smem_optin_limit()))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dw_fwd_kernel<T, K, R, HCW>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int th = R * d * groups_m(R, d);
  const int tiles_x = (W + Geom<HCW>::TW - 1) / Geom<HCW>::TW;
  const int tiles_y = (H + th - 1) / th;
  // 16-byte vectors need whole vectors per pixel and an aligned base
  const int ve = 16 / static_cast<int>(sizeof(T));
  const int vec_ok =
      !HCW && C % ve == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(tiles_x * tiles_y, (C + Geom<HCW>::CT - 1) / Geom<HCW>::CT,
                  N);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), H, W, C, d, w_tap, w_ch,
      tiles_x, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool HCW, typename... A>
int dispatch_r(int r, A... a) {
  if (r == 1) return launch<T, K, 1, HCW>(a...);
  if (r == 4) return launch<T, K, 4, HCW>(a...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool HCW, typename... A>
int dispatch_k(int k, int r, A... a) {
  if (k == 3) return dispatch_r<T, 3, HCW>(r, a...);
  if (k == 5) return dispatch_r<T, 5, HCW>(r, a...);
  if (k == 7) return dispatch_r<T, 7, HCW>(r, a...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename... A>
int dispatch_layout(int hcw, int k, int r, A... a) {
  return hcw ? dispatch_k<T, true>(k, r, a...)
             : dispatch_k<T, false>(k, r, a...);
}

}  // namespace

// Shared memory one block needs (k in {3, 5, 7}, rows-per-thread r in {1, 4},
// dilation d, dtype 0 = f32 / 1 = bf16, hcw 0 = NHWC / 1 = [N, H, C, W]).
extern "C" size_t rs_dw_conv_fwd_smem_bytes(int k, int r, int d, int dtype,
                                            int hcw) {
  if (dtype == 0)
    return hcw ? smem_bytes<float, true>(k, r, d)
               : smem_bytes<float, false>(k, r, d);
  return hcw ? smem_bytes<__nv_bfloat16, true>(k, r, d)
             : smem_bytes<__nv_bfloat16, false>(k, r, d);
}

// x, y: contiguous [N, H, W, C] (hcw = 0) or [N, H, C, W] (hcw = 1) of
// `dtype`; w: tap t of channel c at w[t * w_tap + c * w_ch]; bias: [C] or
// null. y must not alias x. Launches on `stream`; returns cudaGetLastError()
// (0 = success).
extern "C" int rs_dw_conv_fwd(const void* x, const void* w, const void* bias,
                              void* y, int N, int H, int W, int C, int k,
                              int d, long long w_tap, long long w_ch, int r,
                              int dtype, int hcw, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_layout<float>(hcw, k, r, x, w, bias, y, N, H, W, C, d,
                                  w_tap, w_ch, st);
  if (dtype == 1)
    return dispatch_layout<__nv_bfloat16>(hcw, k, r, x, w, bias, y, N, H, W,
                                          C, d, w_tap, w_ch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
