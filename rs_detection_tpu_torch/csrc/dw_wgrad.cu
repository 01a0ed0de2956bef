// Depthwise-conv weight gradient (K6) for Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_dw_wgrad.py, `_wgrad_kernel` (reached
// through `dw_wgrad_pallas` from the custom backward of
// rs_detection_tpu/ops/dw_conv.py:dw_conv). It computes
//   dw[ky, kx, c] = sum_{n,y,x} xpad[n, y + ky*d, x + kx*d, c] * g[n, y, x, c]
// for a stride-1 depthwise conv with symmetric SAME padding p = d*(K-1)/2
// (VAN's dw3, dw5 and dw7 dilation 3), summed in f32, out [K*K, C] f32.
//
// x and g are addressed through their own element strides, so the kernel
// reads NHWC (channels_last) and NCHW tensors alike without a copy: the
// port runs the dilated 7x7 in NCHW and every other depthwise conv in
// channels_last.
//
// What bounds it on the H100: the K*K multiply-adds per (x, g) pair, each of
// which reads its x operand from shared memory (for dw3 on [8, 256, 256,
// 512] that is 2.4 G FMAs against 1.07 GB of x and g from HBM, about equal
// time at the card's rates). The TPU's lesson (docs/perf_notes.md: a tap
// loop that re-reads x and g from HBM once per tap lost) holds here too, so
// each block stages a haloed 16x16-pixel x tile and its g tile, for 32
// channels, in shared memory once and runs all K*K taps from there; a lane
// owns one channel (conflict-free shared reads) and keeps its K*K sums in
// registers across all the tiles the block visits. Each block then reduces
// its 8 warps in shared memory and writes one f32 partial [K*K, 32]; a
// second kernel adds the partials in a fixed order, so the result does not
// depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CT = 32;  // channels per block, one per lane
constexpr int TH = 16;  // output rows per tile
constexpr int TW = 16;  // output columns per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Strides {
  long long n, c, h, w;
};

// shared-memory elements between neighbouring pixels: CT plus 4 bytes of
// padding, so lanes that stage one channel of 32 pixels hit 32 banks
template <typename T> __host__ __device__ constexpr int pixel_stride() {
  return CT + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int K>
size_t smem_bytes(int d) {
  const int halo = (K - 1) * d;
  const size_t stage = static_cast<size_t>((TH + halo) * (TW + halo) +
                                           TH * TW) *
                       pixel_stride<T>() * sizeof(T);
  const size_t red = static_cast<size_t>(WARPS) * K * K * CT * sizeof(float);
  return stage > red ? stage : red;
}

// Copies the [rows x cols x CT] window at (n, y0, x0, c0) of `src` into
// shared memory, zero outside the image and past C. `c_fast` orders the
// copy so consecutive threads read consecutive addresses of `src`.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      const Strides& s, bool c_fast, int n,
                                      int y0, int x0, int c0, int rows,
                                      int cols, int H, int W, int C) {
  constexpr int SP = pixel_stride<T>();
  const int total = rows * cols * CT;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    int c, col, row;
    if (c_fast) {
      c = i % CT;
      const int pix = i / CT;
      col = pix % cols;
      row = pix / cols;
    } else {
      col = i % cols;
      const int rest = i / cols;
      row = rest % rows;
      c = rest / rows;
    }
    const int y = y0 + row;
    const int x = x0 + col;
    const int cc = c0 + c;
    T v = T(0.f);
    if (y >= 0 && y < H && x >= 0 && x < W && cc < C)
      v = src[n * s.n + cc * s.c + y * s.h + x * s.w];
    dst[(row * cols + col) * SP + c] = v;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
    dw_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    Strides xs_, Strides gs_, int N, int C, int H, int W,
                    int d, float* __restrict__ partial) {
  constexpr int SP = pixel_stride<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = (K - 1) * d;
  const int pad = halo / 2;
  const int rh = TH + halo;
  const int rw = TW + halo;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + rh * rw * SP;
  const int c0 = blockIdx.x * CT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool x_cfast = xs_.c == 1;
  const bool g_cfast = gs_.c == 1;
  const int tiles_y = (H + TH - 1) / TH;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = N * tiles_y * tiles_x;

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;

  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int n = tile / (tiles_y * tiles_x);
    const int rem = tile - n * tiles_y * tiles_x;
    const int y0 = (rem / tiles_x) * TH;
    const int x0 = (rem % tiles_x) * TW;
    stage(xs, x, xs_, x_cfast, n, y0 - pad, x0 - pad, c0, rh, rw, H, W, C);
    stage(gs, g, gs_, g_cfast, n, y0, x0, c0, TH, TW, H, W, C);
    __syncthreads();
    for (int p = warp; p < TH * TW; p += WARPS) {
      const int r = p / TW;
      const int cl = p - r * TW;
      const float gv = to_f(gs[p * SP + lane]);
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const T* row = xs + ((r + ky * d) * rw + cl) * SP + lane;
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
          acc[ky * K + kx] += to_f(row[kx * d * SP]) * gv;
      }
    }
    __syncthreads();
  }

  // reduce the 8 warps' sums of each (tap, channel), then one partial row
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < K * K; ++t) red[(warp * K * K + t) * CT + lane] = acc[t];
  __syncthreads();
  for (int i = threadIdx.x; i < K * K * CT; i += THREADS) {
    const int t = i / CT;
    const int c = i - t * CT;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * K * K + t) * CT + c];
    if (c0 + c < C)
      partial[(static_cast<size_t>(blockIdx.y) * K * K + t) * C + c0 + c] = s;
  }
}

__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int parts, int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < parts; ++j) s += partial[static_cast<size_t>(j) * n + i];
  out[i] = s;
}

template <typename T, int K>
int launch(const void* x, const void* g, const Strides& xs, const Strides& gs,
           int N, int C, int H, int W, int d, int parts, float* partial,
           float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, K>(d);
  cudaError_t e = cudaFuncSetAttribute(
      dw_wgrad_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((C + CT - 1) / CT, parts);
  dw_wgrad_kernel<T, K><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), xs, gs, N, C, H, W,
      d, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = K * K * C;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, parts, n,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(int k, const void* x, const void* g, const Strides& xs,
               const Strides& gs, int N, int C, int H, int W, int d,
               int parts, float* partial, float* out, cudaStream_t st) {
  if (k == 3)
    return launch<T, 3>(x, g, xs, gs, N, C, H, W, d, parts, partial, out, st);
  if (k == 5)
    return launch<T, 5>(x, g, xs, gs, N, C, H, W, d, parts, partial, out, st);
  if (k == 7)
    return launch<T, 7>(x, g, xs, gs, N, C, H, W, d, parts, partial, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Shared memory one block needs for kernel size k, dilation d and dtype
// (0 = f32, 1 = bf16); 0 for an unsupported k or dtype.
extern "C" size_t rs_dw_wgrad_smem_bytes(int k, int d, int dtype) {
  if (dtype == 0) {
    if (k == 3) return smem_bytes<float, 3>(d);
    if (k == 5) return smem_bytes<float, 5>(d);
    if (k == 7) return smem_bytes<float, 7>(d);
  } else if (dtype == 1) {
    if (k == 3) return smem_bytes<__nv_bfloat16, 3>(d);
    if (k == 5) return smem_bytes<__nv_bfloat16, 5>(d);
    if (k == 7) return smem_bytes<__nv_bfloat16, 7>(d);
  }
  return 0;
}

// x, g: logical [N, C, H, W] tensors of `dtype` (0 = f32, 1 = bf16) with
// element strides (xsn, xsc, xsh, xsw) and (gsn, gsc, gsh, gsw). k in {3, 5,
// 7}, dilation d >= 1. partial: [parts, k*k, C] f32 scratch; out: [k*k, C]
// f32. Launches on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int rs_dw_wgrad(const void* x, const void* g, long long xsn,
                           long long xsc, long long xsh, long long xsw,
                           long long gsn, long long gsc, long long gsh,
                           long long gsw, int N, int C, int H, int W, int k,
                           int d, int dtype, int parts, void* partial,
                           void* out, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || d < 1 || parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs = {xsn, xsc, xsh, xsw};
  const Strides gs = {gsn, gsc, gsh, gsw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return dispatch_k<float>(k, x, g, xs, gs, N, C, H, W, d, parts, p, o, st);
  if (dtype == 1)
    return dispatch_k<__nv_bfloat16>(k, x, g, xs, gs, N, C, H, W, d, parts, p,
                                     o, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
