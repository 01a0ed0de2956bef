// Depthwise-conv weight gradient (K6) for Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_dw_wgrad.py, `_wgrad_kernel` (reached
// through `dw_wgrad_pallas` from the custom backward of
// rs_detection_tpu/ops/dw_conv.py:dw_conv). It computes
//   dw[ky, kx, c] = sum_{n,y,x} xpad[n, y + ky*d, x + kx*d, c] * g[n, y, x, c]
// for a stride-1 depthwise conv with symmetric SAME padding p = d*(K-1)/2
// (VAN's dw3, dw5 and dw7 dilation 3), summed in f32, out [K*K, C] f32.
//
// x and g are addressed through their own element strides, so NHWC
// (channels_last) and NCHW tensors are read without a copy: the port runs the
// dilated 7x7 in NCHW and every other depthwise conv in channels_last.
//
// What bounds it on the H100: by the roofline the bytes of x and g (14.5 GB
// per VAN-b3 step, 4.5 ms), in practice the work around the K*K
// multiply-adds per (x, g) pair: the first design loaded its x operand from
// shared memory again for every multiply-add, two bytes a lane, staged its
// tiles one element per thread, and waited for each tile before it started
// on it. Three kernels now, picked by the launcher from the strides:
//   * channels fastest (NHWC), VAN's (K, d) = (3, 1), (5, 1), (7, 3):
//     `dw_wgrad_nhwc_kernel`. A
//     block takes 64 channels and walks 8x16-pixel tiles; a lane owns two
//     neighbouring channels (one 32-bit shared load brings both), a warp one
//     output row. It keeps the g values of a run of 8 outputs in registers
//     and walks the x row once per ky: each x value is loaded once and feeds
//     all K taps of that row. The next tile arrives by 16-byte cp.async into
//     a second buffer while this one's taps run.
//   * width fastest (NCHW), the same (K, d): `dw_wgrad_nchw_kernel`. A block
//     takes one channel and walks bands of full rows; a thread owns a run of
//     8 outputs of one row and loads its x window in 16-byte vectors along
//     the width (26 values serve the 56 multiply-adds of a ky at K = 7,
//     d = 3). Rows are staged as they lie in memory, 16 bytes at a time,
//     double-buffered; the halo rows of a band are the only re-read.
//   * any other (K, d) or a mix of formats: `dw_wgrad_kernel`, the first
//     design (a haloed 16x16 tile of 32 channels, one channel per lane).
// Each keeps its K*K sums in registers across all the tiles the block visits,
// reduces them over the block in a fixed order and writes one f32 partial
// row; `sum_partials_kernel` adds the partials in a fixed order, so the
// result does not depend on scheduling.

#include <stdint.h>

#include "rs_common.cuh"

namespace {

using rs::cp_async16;
using rs::cp_async_commit;
using rs::cp_async_wait;
using rs::to_f;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CT = 32;  // channels per block, one per lane
constexpr int TH = 16;  // output rows per tile
constexpr int TW = 16;  // output columns per tile

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

// ---------------------------------------------------------------------------
// The two designs for the model's layouts
// ---------------------------------------------------------------------------

// two neighbouring elements at `p` as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned v = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

constexpr int NHWC_CT = 64;  // channels per block of the NHWC design
constexpr int NHWC_TH = 8;   // output rows per tile, one per warp
constexpr int RUN = 8;       // outputs a thread walks with g in registers

// pixels of one staging buffer: the haloed x tile and the g tile
constexpr int nhwc_pixels(int halo, int tw) {
  return (NHWC_TH + halo) * (tw + halo) + NHWC_TH * tw;
}

template <typename T, int K, int D> struct NhwcShape {
  static constexpr int HALO = (K - 1) * D;
  static constexpr int PIXB = NHWC_CT * sizeof(T);  // bytes per pixel
  // 16 output columns where one buffer of that tile leaves room for the
  // reduction scratch and the device's limit, else 8
  static constexpr int TW = nhwc_pixels(HALO, 16) * PIXB <= 200 * 1024 ? 16 : 8;
  static constexpr int RH = NHWC_TH + HALO;
  static constexpr int RW = TW + HALO;
  static constexpr int BUF = nhwc_pixels(HALO, TW) * PIXB;
  static constexpr int NBUF = 2 * BUF <= 224 * 1024 ? 2 : 1;
  static constexpr int RED = WARPS * K * K * NHWC_CT * 4;
  static constexpr int SMEM = NBUF * BUF > RED ? NBUF * BUF : RED;
  static constexpr int MIN_BLOCKS = (K < 7 && 2 * SMEM <= 224 * 1024) ? 2 : 1;
};

// Copies the [ROWS x COLS x 64 channels] window at (n, y0, x0, c0) of an NHWC
// tensor into shared memory, zero outside the image and past C: by 16-byte
// cp.async when `vec` (every stride and the base 16-byte aligned), else one
// element at a time.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void stage_nhwc(T* dst, const T* __restrict__ src,
                                           const Strides& s, bool vec, int n,
                                           int y0, int x0, int c0, int H,
                                           int W, int C) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VP = NHWC_CT / EPV;
  const T* base = src + n * s.n;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * COLS * VP; i += THREADS) {
      const int v = i % VP;
      const int pix = i / VP;
      const int y = y0 + pix / COLS;
      const int x = x0 + pix % COLS;
      const int c = c0 + v * EPV;
      const bool in = y >= 0 && y < H && x >= 0 && x < W && c < C;
      cp_async16(dst + pix * NHWC_CT + v * EPV,
           in ? base + y * s.h + x * s.w + c : nullptr, src);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS * NHWC_CT; i += THREADS) {
      const int c = i % NHWC_CT;
      const int pix = i / NHWC_CT;
      const int y = y0 + pix / COLS;
      const int x = x0 + pix % COLS;
      T v = T(0.f);
      if (y >= 0 && y < H && x >= 0 && x < W && c0 + c < C)
        v = base[y * s.h + x * s.w + c0 + c];
      dst[i] = v;
    }
  }
}

template <typename T, int K, int D>
__global__ void
__launch_bounds__(THREADS, NhwcShape<T, K, D>::MIN_BLOCKS)
    dw_wgrad_nhwc_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         Strides xs_, Strides gs_, int xvec, int gvec, int N,
                         int C, int H, int W, float* __restrict__ partial) {
  using S = NhwcShape<T, K, D>;
  constexpr int TW = S::TW, RH = S::RH, RW = S::RW;
  constexpr int PAD = S::HALO / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = blockIdx.x * NHWC_CT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles_y = (H + NHWC_TH - 1) / NHWC_TH;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = N * tiles_y * tiles_x;

  auto xbuf = [&](int b) { return reinterpret_cast<T*>(smem + b * S::BUF); };
  auto gbuf = [&](int b) { return xbuf(b) + RH * RW * NHWC_CT; };
  auto stage = [&](int tile, int b) {
    const int n = tile / (tiles_y * tiles_x);
    const int rem = tile - n * tiles_y * tiles_x;
    const int y0 = (rem / tiles_x) * NHWC_TH;
    const int x0 = (rem % tiles_x) * TW;
    stage_nhwc<T, RH, RW>(xbuf(b), x, xs_, xvec, n, y0 - PAD, x0 - PAD, c0, H,
                          W, C);
    stage_nhwc<T, NHWC_TH, TW>(gbuf(b), g, gs_, gvec, n, y0, x0, c0, H, W, C);
    cp_async_commit();
  };

  float acc[K * K][2];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t][0] = acc[t][1] = 0.f;

  int buf = 0;
  if (blockIdx.y < tiles) stage(blockIdx.y, 0);
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    if (S::NBUF == 2) {
      if (tile + gridDim.y < tiles) {
        stage(tile + gridDim.y, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // this warp's output row, this lane's two channels
    const T* xt = xbuf(buf) + 2 * lane;
    const T* gt = gbuf(buf) + warp * TW * NHWC_CT + 2 * lane;
#pragma unroll 1
    for (int seg = 0; seg < TW / RUN; ++seg) {
      float2 gv[RUN];
#pragma unroll
      for (int o = 0; o < RUN; ++o)
        gv[o] = load2(gt + (seg * RUN + o) * NHWC_CT);
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const T* row = xt + ((warp + ky * D) * RW + seg * RUN) * NHWC_CT;
#pragma unroll
        for (int xc = 0; xc < RUN + S::HALO; ++xc) {
          const float2 xv = load2(row + xc * NHWC_CT);
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const int o = xc - kx * D;
            if (o >= 0 && o < RUN) {
              acc[ky * K + kx][0] = fmaf(xv.x, gv[o].x, acc[ky * K + kx][0]);
              acc[ky * K + kx][1] = fmaf(xv.y, gv[o].y, acc[ky * K + kx][1]);
            }
          }
        }
      }
    }
    __syncthreads();
    if (S::NBUF == 2) {
      buf ^= 1;
    } else if (tile + gridDim.y < tiles) {
      stage(tile + gridDim.y, 0);
    }
  }

  // reduce the 8 warps' sums of each (tap, channel), then one partial row
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    *reinterpret_cast<float2*>(red + (warp * K * K + t) * NHWC_CT + 2 * lane) =
        make_float2(acc[t][0], acc[t][1]);
  __syncthreads();
  for (int i = threadIdx.x; i < K * K * NHWC_CT; i += THREADS) {
    const int t = i / NHWC_CT;
    const int c = i - t * NHWC_CT;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * K * K + t) * NHWC_CT + c];
    if (c0 + c < C)
      partial[(static_cast<size_t>(blockIdx.y) * K * K + t) * C + c0 + c] = s;
  }
}

// The NCHW design. A band is `th` output rows of one (image, channel) plane
// at full width. Shared rows: x [th + HALO][xw] with the image's column 0 at
// element NCHW_PADL (zeros left and right of it), g [th][gw], gw = W rounded
// up to 8 (zeros past W), xw = NCHW_PADL + gw + 16.
constexpr int NCHW_PADL = 16;

__host__ __device__ inline int nchw_gw(int W) { return (W + 7) / 8 * 8; }
__host__ __device__ inline int nchw_xw(int W) {
  return NCHW_PADL + nchw_gw(W) + 16;
}
template <typename T>
inline size_t nchw_smem_bytes(int th, int halo, int W) {
  const size_t buf = (static_cast<size_t>(th + halo) * nchw_xw(W) +
                      static_cast<size_t>(th) * nchw_gw(W)) * sizeof(T);
  const size_t red = static_cast<size_t>(WARPS) * 49 * sizeof(float);
  return 2 * buf > red ? 2 * buf : red;
}

// Copies rows [y0, y0 + rows) of plane `src` (row stride sh, width W) into
// shared rows of `width` elements with the image's column 0 at element
// `left`; zero outside the image.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           long long sh, bool vec, int y0,
                                           int rows, int width, int left,
                                           int H, int W) {
  constexpr int EPV = 16 / sizeof(T);
  if (vec) {
    const int vpr = width / EPV;
    for (int i = threadIdx.x; i < rows * vpr; i += THREADS) {
      const int r = i / vpr;
      const int v = i - r * vpr;
      const int y = y0 + r;
      const int col = v * EPV - left;
      const bool in = y >= 0 && y < H && col >= 0 && col < W;
      cp_async16(dst + r * width + v * EPV,
                 in ? src + y * sh + col : nullptr, src);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += THREADS) {
      const int r = i / width;
      const int y = y0 + r;
      const int col = i - r * width - left;
      T v = T(0.f);
      if (y >= 0 && y < H && col >= 0 && col < W) v = src[y * sh + col];
      dst[i] = v;
    }
  }
}

// eight neighbouring elements at the 16-byte aligned `p` as f32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int K, int D>
__global__ void __launch_bounds__(THREADS, 2)
    dw_wgrad_nchw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         Strides xs_, Strides gs_, int xvec, int gvec, int N,
                         int C, int H, int W, int th,
                         float* __restrict__ partial) {
  constexpr int HALO = (K - 1) * D;
  constexpr int PAD = HALO / 2;
  constexpr int OFF = (NCHW_PADL - PAD) % 8;  // window start past alignment
  constexpr int NV = (OFF + RUN + HALO + 7) / 8;  // 8-element vectors
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int gw = nchw_gw(W);
  const int xw = nchw_xw(W);
  const int segs = gw / RUN;
  const int bands = (H + th - 1) / th;
  const int items = N * bands;
  const int buf_elems = (th + HALO) * xw + th * gw;

  auto xbuf = [&](int b) { return reinterpret_cast<T*>(smem) + b * buf_elems; };
  auto stage = [&](int item, int b) {
    const int n = item / bands;
    const int y0 = (item - n * bands) * th;
    stage_rows(xbuf(b), x + n * xs_.n + c * xs_.c, xs_.h, xvec, y0 - PAD,
               th + HALO, xw, NCHW_PADL, H, W);
    stage_rows(xbuf(b) + (th + HALO) * xw, g + n * gs_.n + c * gs_.c, gs_.h,
               gvec, y0, th, gw, 0, H, W);
    cp_async_commit();
  };

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;

  int buf = 0;
  if (blockIdx.y < items) stage(blockIdx.y, 0);
  for (int item = blockIdx.y; item < items; item += gridDim.y) {
    if (item + gridDim.y < items) {
      stage(item + gridDim.y, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* xb = xbuf(buf);
    const T* gb = xb + (th + HALO) * xw;
    for (int task = threadIdx.x; task < th * segs; task += THREADS) {
      const int r = task / segs;
      const int s = task - r * segs;
      float gv[RUN];
      load8(gb + r * gw + s * RUN, gv);
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        // the aligned vectors that cover columns [s*8 - PAD, s*8 + 8 + PAD)
        const T* row =
            xb + (r + ky * D) * xw + (NCHW_PADL - PAD - OFF) + s * RUN;
        float xv[NV * 8];
#pragma unroll
        for (int v = 0; v < NV; ++v) load8(row + v * 8, xv + v * 8);
#pragma unroll
        for (int kx = 0; kx < K; ++kx)
#pragma unroll
          for (int o = 0; o < RUN; ++o)
            acc[ky * K + kx] =
                fmaf(xv[OFF + o + kx * D], gv[o], acc[ky * K + kx]);
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // each tap: the warp's 32 sums by a fixed shuffle tree, then the 8 warps
  float* red = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    float v = acc[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * K * K + t] = v;
  }
  __syncthreads();
  if (threadIdx.x < K * K) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * K * K + threadIdx.x];
    partial[(static_cast<size_t>(blockIdx.y) * K * K + threadIdx.x) * C + c] =
        s;
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

enum Design { GENERIC = 0, NHWC = 1, NCHW = 2 };

// What the launcher does with a call: the design, its shared memory, its
// blocks along the channels (grid x) and the spatial work items the `parts`
// blocks of grid y share out (tiles or bands), and the NCHW band height.
struct Plan {
  int design, smem, ctiles, items, th;
};

// rows of an NCHW band: about 4096 outputs (two runs of 8 per thread), halved
// until two buffers fit in 96 KB (two blocks on an SM)
template <typename T> int nchw_band_rows(int halo, int H, int W) {
  int th = 4096 / nchw_gw(W);
  th = th < 1 ? 1 : th > H ? H : th;
  while (th > 1 && nchw_smem_bytes<T>(th, halo, W) > 96 * 1024)
    th = (th + 1) / 2;
  return th;
}

template <typename T, int K, int D> int nhwc_smem() {
  return NhwcShape<T, K, D>::SMEM;
}
template <typename T, int K, int D> int nhwc_tw() {
  return NhwcShape<T, K, D>::TW;
}

// f(K-constant, D-constant) for the (k, d) pairs the two designs are built
// for, VAN's three depthwise convs; `otherwise` for the rest
#define RS_DW_KD(k, d, CALL, otherwise)                     \
  ((k) == 3 && (d) == 1   ? CALL(3, 1)                      \
   : (k) == 5 && (d) == 1 ? CALL(5, 1)                      \
   : (k) == 7 && (d) == 3 ? CALL(7, 3)                      \
                          : (otherwise))
inline bool fast_kd(int k, int d) {
  return (k == 3 && d == 1) || (k == 5 && d == 1) || (k == 7 && d == 3);
}

template <typename T>
Plan plan_of(const Strides& xs, const Strides& gs, int N, int C, int H, int W,
             int k, int d) {
  Plan p{GENERIC, 0, (C + CT - 1) / CT,
         N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW), 0};
  p.smem = static_cast<int>(k == 3   ? smem_bytes<T, 3>(d)
                            : k == 5 ? smem_bytes<T, 5>(d)
                                     : smem_bytes<T, 7>(d));
  if (!fast_kd(k, d)) return p;
  if (xs.c == 1 && gs.c == 1) {
#define RS_TW(K_, D_) nhwc_tw<T, K_, D_>()
#define RS_SMEM(K_, D_) nhwc_smem<T, K_, D_>()
    const int tw = RS_DW_KD(k, d, RS_TW, 16);
    p.design = NHWC;
    p.smem = RS_DW_KD(k, d, RS_SMEM, 0);
#undef RS_TW
#undef RS_SMEM
    p.ctiles = (C + NHWC_CT - 1) / NHWC_CT;
    p.items = N * ((H + NHWC_TH - 1) / NHWC_TH) * ((W + tw - 1) / tw);
  } else if (xs.w == 1 && gs.w == 1) {
    const int halo = (k - 1) * d;
    const int th = nchw_band_rows<T>(halo, H, W);
    const size_t smem = nchw_smem_bytes<T>(th, halo, W);
    if (smem > static_cast<size_t>(rs::smem_optin_limit())) return p;
    p.design = NCHW;
    p.smem = static_cast<int>(smem);
    p.ctiles = C;
    p.items = N * ((H + th - 1) / th);
    p.th = th;
  }
  return p;
}

// true when rows of `fast` elements can be copied in 16-byte vectors
template <typename T>
bool vec_ok(const void* p, long long fast, long long s0, long long s1,
            long long s2) {
  const long long epv = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && fast % epv == 0 &&
         s0 % epv == 0 && s1 % epv == 0 && s2 % epv == 0;
}

template <typename T, int K, int D>
int launch_fast(const Plan& p, const T* x, const T* g, const Strides& xs,
                const Strides& gs, int N, int C, int H, int W, int parts,
                float* partial, cudaStream_t stream) {
  const dim3 grid(p.ctiles, parts);
  if (p.design == NHWC) {
    auto kernel = dw_wgrad_nhwc_kernel<T, K, D>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, THREADS, p.smem, stream>>>(
        x, g, xs, gs, vec_ok<T>(x, C, xs.n, xs.h, xs.w),
        vec_ok<T>(g, C, gs.n, gs.h, gs.w), N, C, H, W, partial);
  } else {
    auto kernel = dw_wgrad_nchw_kernel<T, K, D>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, THREADS, p.smem, stream>>>(
        x, g, xs, gs, vec_ok<T>(x, W, xs.n, xs.c, xs.h),
        vec_ok<T>(g, W, gs.n, gs.c, gs.h), N, C, H, W, p.th, partial);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_generic(const Plan& p, const T* x, const T* g, const Strides& xs,
                   const Strides& gs, int N, int C, int H, int W, int d,
                   int parts, float* partial, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      dw_wgrad_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dw_wgrad_kernel<T, K><<<dim3(p.ctiles, parts), THREADS, p.smem, stream>>>(
      x, g, xs, gs, N, C, H, W, d, partial);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xv, const void* gv, const Strides& xs,
           const Strides& gs, int N, int C, int H, int W, int k, int d,
           int parts, float* partial, float* out, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* g = static_cast<const T*>(gv);
  const Plan p = plan_of<T>(xs, gs, N, C, H, W, k, d);
  int err;
  if (p.design == GENERIC) {
    err = k == 3 ? launch_generic<T, 3>(p, x, g, xs, gs, N, C, H, W, d, parts,
                                        partial, stream)
        : k == 5 ? launch_generic<T, 5>(p, x, g, xs, gs, N, C, H, W, d, parts,
                                        partial, stream)
                 : launch_generic<T, 7>(p, x, g, xs, gs, N, C, H, W, d, parts,
                                        partial, stream);
  } else {
#define RS_LAUNCH(K_, D_)                                                   \
  launch_fast<T, K_, D_>(p, x, g, xs, gs, N, C, H, W, parts, partial, stream)
    err = RS_DW_KD(k, d, RS_LAUNCH, static_cast<int>(cudaErrorInvalidValue));
#undef RS_LAUNCH
  }
  if (err != 0) return err;
  const int n = k * k * C;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partial, parts, n,
                                                           out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launcher's plan for a call, as rs_dw_wgrad would run it: out[0] the
// design (0 = the first design, 1 = NHWC, 2 = NCHW), out[1] the shared memory
// of one block, out[2] the blocks along the channels, out[3] the spatial work
// items (tiles or bands) that the `parts` blocks share out. Returns 0, or
// nonzero for an unsupported k or dtype.
extern "C" int rs_dw_wgrad_plan(long long xsn, long long xsc, long long xsh,
                                long long xsw, long long gsn, long long gsc,
                                long long gsh, long long gsw, int N, int C,
                                int H, int W, int k, int d, int dtype,
                                int* out) {
  if ((k != 3 && k != 5 && k != 7) || d < 1 || (dtype != 0 && dtype != 1))
    return 1;
  const Strides xs = {xsn, xsc, xsh, xsw};
  const Strides gs = {gsn, gsc, gsh, gsw};
  const Plan p = dtype == 0
                     ? plan_of<float>(xs, gs, N, C, H, W, k, d)
                     : plan_of<__nv_bfloat16>(xs, gs, N, C, H, W, k, d);
  out[0] = p.design;
  out[1] = p.smem;
  out[2] = p.ctiles;
  out[3] = p.items;
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
  if (N < 1 || C < 1 || H < 1 || W < 1 || d < 1 || parts < 1 ||
      (k != 3 && k != 5 && k != 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs = {xsn, xsc, xsh, xsw};
  const Strides gs = {gsn, gsc, gsh, gsw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return launch<float>(x, g, xs, gs, N, C, H, W, k, d, parts, p, o, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, xs, gs, N, C, H, W, k, d, parts, p, o,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
