// Fused VAN MLP forward for Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_van_mlp.py, `_mlp_kernel` (reached
// through `van_mlp`), the TPU kernel that runs in every VAN block.
//
// Computes, for x [N, H, W, C] (NHWC, contiguous) and weights laid out as
// nn.Conv2d holds them (w1 [Ch, C], wdw [Ch, 9], w2 [C, Ch]):
//   h1 = x @ w1^T + b1                rounded to the input dtype
//   h1 = 0 outside the image          (SAME padding of the *hidden* tensor:
//                                      fc1 of a padded zero is b1, not 0)
//   h2 = gelu_erf(dw3x3(h1) + bdw)    rounded to the input dtype
//   y  = h2 @ w2^T + b2            (+ x with `residual`, added in f32 from the
//                                    x tile in shared memory before the one
//                                    cast: `van_mlp_residual`, :187-191)
// The two rounding points are the TPU kernel's (pallas_van_mlp.py:121, :168).
//
// What bounds it on the H100: unfused, the Ch-wide hidden tensor (4-8x the
// size of x) crosses HBM three times (fc1 out, dw out, gelu out), which makes
// the MLP memory-bound at 3.35 TB/s. Fused, one block owns an 8x8 output tile
// of one image: it loads the haloed 10x10 x patch into shared memory once,
// then walks the hidden channels in chunks (fc1 of the haloed patch, zero
// padding, dw 3x3, gelu, fc2 accumulate), so the hidden tensor lives only in
// shared memory and HBM sees read-x plus write-y.
//
// Three kernels compute it, and the launcher at the end of this file picks by
// shape:
//   * bf16 at C in {64, 128, 256, 320, 512} with Ch a multiple of 8, which is
//     every VAN-b3 stage: the wgmma design of van_mlp_wgmma.cu (its header
//     says what bounds it and what it does about that).
//   * f32 at any width: the f32 design of van_mlp_f32.cu (plain FMAs, the fc2
//     sums in registers, shared memory bounded whatever C).
//   * every other bf16 shape (C in {32, 160}, or Ch no multiple of 8):
//     `van_mlp_kernel` below, the first design. Both 1x1 convs run through
//     WMMA 16x16x16 fragments with f32 accumulation, the fc2 accumulators in
//     registers across 32-channel chunks; weight chunks arrive by cp.async,
//     double-buffered where shared memory allows (C <= 320). It is bound by
//     latency: one to three blocks per SM, three block barriers per chunk,
//     fc1's sums through shared memory in f32.
//
// The int8 serving form of the same function is van_mlp_int8.cu.

#include <mma.h>

#include "rs_common.cuh"
#include "van_mlp.cuh"

namespace {

using namespace rs;

constexpr int TILE = 8;              // output tile is TILE x TILE pixels
constexpr int HALO = TILE + 2;       // haloed tile side
constexpr int NPIX_H = HALO * HALO;  // haloed pixels
constexpr int MROWS = 112;           // haloed pixels padded to 7 x 16 rows
constexpr int NOUT = TILE * TILE;    // output pixels
constexpr int KC = 32;               // hidden channels per chunk
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HS_LD = KC + 4;        // f32 row stride of the fc1 chunk
constexpr int GS_LD = KC + 8;        // row stride of the gelu chunk

using T = __nv_bfloat16;

// Row strides: rows are padded by 8 elements (WMMA wants a multiple of 8 and
// 32-byte aligned fragments).
__host__ __device__ constexpr int ld_x(int c) { return c + 8; }
constexpr int LD_W2 = KC + 8;

struct Layout {
  size_t xs, w1s, w2s, vs, hs, gs, extra, total;
  size_t w1s_buf, w2s_buf, vs_buf;  // bytes between the staging buffers
};

// Shared-memory carve-up for `nbuf` (1 or 2) staging buffers of each weight
// chunk. `vs` holds a chunk's b1, bdw and 3x3 taps; `extra` holds the
// per-warp output staging tiles.
__host__ __device__ inline Layout layout_of(int c, int nbuf) {
  Layout l;
  size_t o = 0;
  l.xs = o;
  o += up128(static_cast<size_t>(MROWS) * ld_x(c) * sizeof(T));
  l.w1s_buf = up128(static_cast<size_t>(KC) * ld_x(c) * sizeof(T));
  l.w1s = o;
  o += nbuf * l.w1s_buf;
  l.w2s_buf = up128(static_cast<size_t>(c) * LD_W2 * sizeof(T));
  l.w2s = o;
  o += nbuf * l.w2s_buf;
  l.vs_buf = up128(static_cast<size_t>(KC) * 11 * sizeof(T));
  l.vs = o;
  o += nbuf * l.vs_buf;
  l.hs = o;
  o += up128(static_cast<size_t>(MROWS) * HS_LD * sizeof(float));
  l.gs = o;
  o += up128(static_cast<size_t>(NOUT) * GS_LD * sizeof(T));
  l.extra = o;
  o += up128(static_cast<size_t>(WARPS) * 256 * sizeof(float));
  l.total = o;
  return l;
}

// NFW: fc2 accumulator fragments per warp (C = 32 * NFW). nbuf: 2
// double-buffers the weight chunks
// (chunk k+1 is copied while chunk k computes), 1 when shared memory is
// too small for that. The launch bounds keep narrow stages at 2-3 blocks
// per SM (shared memory allows that much there); otherwise the compiler
// spends registers freely and one block fills the register file.
template <int NFW>
__global__ void __launch_bounds__(THREADS, NFW <= 2 ? 3 : NFW <= 4 ? 2 : 1)
    van_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ wdw,
                   const T* __restrict__ bdw, const T* __restrict__ w2,
                   const T* __restrict__ b2, T* __restrict__ y, int H, int W,
                   int C, int Ch, int tiles_x, int nbuf, int residual) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_of(C, nbuf);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  T* gs = reinterpret_cast<T*>(smem + L.gs);
  float* extra = reinterpret_cast<float*>(smem + L.extra);

  const int ldx = ld_x(C);
  const int ldw2 = LD_W2;
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE;
  const int tx0 = (blockIdx.x % tiles_x) * TILE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* xn = x + static_cast<size_t>(n) * H * W * C;

  // haloed x patch; zero outside the image and in the padding rows
  {
    const int vpp = C / 8;  // 16-byte vectors per pixel
    copy_vec16(
        MROWS * vpp, x,
        [&](int i) -> const T* {
          const int p = i / vpp;
          const int gy = ty0 - 1 + p / HALO;
          const int gx = tx0 - 1 + p % HALO;
          if (p >= NPIX_H || gy < 0 || gy >= H || gx < 0 || gx >= W)
            return nullptr;
          return xn + (static_cast<size_t>(gy) * W + gx) * C + (i - p * vpp) * 8;
        },
        [&](int i) {
          const int p = i / vpp;
          return xs + p * ldx + (i - p * vpp) * 8;
        });
  }

  // stage hidden chunk [k0, k0 + KC) of w1, w2, b1, bdw, wdw into buffer buf
  auto stage = [&](int k0, int buf) {
    T* w1s = reinterpret_cast<T*>(smem + L.w1s + buf * L.w1s_buf);
    T* w2s = reinterpret_cast<T*>(smem + L.w2s + buf * L.w2s_buf);
    T* vs = reinterpret_cast<T*>(smem + L.vs + buf * L.vs_buf);
    if (Ch % KC == 0) {
      // whole chunks: rows of w1 and row segments of w2 in 16-byte vectors
      const int vpr = C / 8;
      copy_vec16(
          KC * vpr, w1,
          [&](int i) {
            const int j = i / vpr;
            return w1 + static_cast<size_t>(k0 + j) * C + (i - j * vpr) * 8;
          },
          [&](int i) {
            const int j = i / vpr;
            return w1s + j * ldx + (i - j * vpr) * 8;
          });
      copy_vec16(
          C * (KC / 8), w2,
          [&](int i) {
            return w2 + static_cast<size_t>(i / (KC / 8)) * Ch + k0 +
                   (i % (KC / 8)) * 8;
          },
          [&](int i) { return w2s + (i / (KC / 8)) * ldw2 + (i % (KC / 8)) * 8; });
      // vs = [b1 (KC) | bdw (KC) | wdw (KC x 9)], 4 + 4 + 36 vectors
      copy_vec16(
          KC * 11 / 8, b1,
          [&](int i) {
            return i < KC / 8 ? b1 + k0 + i * 8
                 : i < KC / 4 ? bdw + k0 + (i - KC / 8) * 8
                              : wdw + static_cast<size_t>(k0) * 9 +
                                    (i - KC / 4) * 8;
          },
          [&](int i) { return vs + i * 8; });
    } else {
      for (int i = tid; i < KC * C; i += THREADS) {
        const int j = i / C;
        const int c = i - j * C;
        w1s[j * ldx + c] = k0 + j < Ch
                               ? w1[static_cast<size_t>(k0 + j) * C + c]
                               : from_f<T>(0.f);
      }
      for (int i = tid; i < C * KC; i += THREADS) {
        const int c = i / KC;
        const int j = i - c * KC;
        w2s[c * ldw2 + j] = k0 + j < Ch
                                ? w2[static_cast<size_t>(c) * Ch + k0 + j]
                                : from_f<T>(0.f);
      }
      // vs = [b1 (KC) | bdw (KC) | wdw (KC x 9)], zero past Ch
      for (int i = tid; i < KC * 11; i += THREADS) {
        const int j = i < 2 * KC ? i % KC : (i - 2 * KC) / 9;
        T v = from_f<T>(0.f);
        if (k0 + j < Ch)
          v = i < KC ? b1[k0 + j]
            : i < 2 * KC ? bdw[k0 + j]
                         : wdw[static_cast<size_t>(k0) * 9 + (i - 2 * KC)];
        vs[i] = v;
      }
    }
  };

  // + b1, round to the input dtype, and zero the hidden tensor's SAME
  // padding, for haloed pixel p and chunk channel j
  auto finish_h1 = [&](int p, int j, float s, const T* vb1) {
    const int gy = ty0 - 1 + p / HALO;
    const int gx = tx0 - 1 + p % HALO;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    return in ? round_to<T>(s + to_f(vb1[j])) : 0.f;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NFW];
#pragma unroll
  for (int f = 0; f < NFW; ++f) wmma::fill_fragment(acc[f], 0.f);

  stage(0, 0);
  for (int k0 = 0, it = 0; k0 < Ch; k0 += KC, ++it) {
    const int buf = nbuf == 2 ? (it & 1) : 0;
    cp_async_wait_all();
    // chunk k0 is in shared memory, and every warp is done with the
    // previous chunk (so its buffer, hs and gs may be overwritten)
    __syncthreads();
    if (nbuf == 2 && k0 + KC < Ch) stage(k0 + KC, buf ^ 1);
    const T* w1s = reinterpret_cast<const T*>(smem + L.w1s + buf * L.w1s_buf);
    const T* w2s = reinterpret_cast<const T*>(smem + L.w2s + buf * L.w2s_buf);
    const T* vb1 = reinterpret_cast<const T*>(smem + L.vs + buf * L.vs_buf);
    const T* vbdw = vb1 + KC;
    const T* vwdw = vbdw + KC;  // [KC][9]

    // fc1 of the haloed patch for this chunk, then finish_h1:
    // hs[p][j] = h1(sum_c x[p][c] w1[j][c]); one 16-pixel row block per warp,
    // both 16-channel halves of the chunk
    for (int mi = warp; mi < MROWS / 16; mi += WARPS) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h0, h1;
      wmma::fill_fragment(h0, 0.f);
      wmma::fill_fragment(h1, 0.f);
      for (int kk = 0; kk < C; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, xs + mi * 16 * ldx + kk, ldx);
        wmma::load_matrix_sync(b, w1s + kk, ldx);
        wmma::mma_sync(h0, a, b, h0);
        wmma::load_matrix_sync(b, w1s + 16 * ldx + kk, ldx);
        wmma::mma_sync(h1, a, b, h1);
      }
      float* hrow = hs + mi * 16 * HS_LD;
      wmma::store_matrix_sync(hrow, h0, HS_LD, wmma::mem_row_major);
      wmma::store_matrix_sync(hrow + 16, h1, HS_LD, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * KC; e += 32) {
        const int p = mi * 16 + e / KC;
        const int j = e % KC;
        if (p < NPIX_H)
          hrow[(e / KC) * HS_LD + j] =
              finish_h1(p, j, hrow[(e / KC) * HS_LD + j], vb1);
      }
    }
    __syncthreads();

    // depthwise 3x3 + bdw + erf gelu, rounded to the input dtype; channels
    // past Ch have zero taps and bias, so they give gelu(0) = 0
    for (int i = tid; i < NOUT * KC; i += THREADS) {
      const int q = i / KC;
      const int j = i - q * KC;
      const int qy = q / TILE;
      const int qx = q - qy * TILE;
      const T* wt = vwdw + j * 9;
      float a = 0.f;
      for (int dx = 0; dx < 3; ++dx)
        for (int dy = 0; dy < 3; ++dy)
          a += hs[((qy + dy) * HALO + qx + dx) * HS_LD + j] *
               to_f(wt[dy * 3 + dx]);
      gs[q * GS_LD + j] = from_f<T>(gelu_erf(a + to_f(vbdw[j])));
    }
    __syncthreads();

    // fc2 partial sums: y[q][c] += sum_j g[q][j] w2[c][k0 + j]
    {
      const int mi = warp & 3;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, gs + mi * 16 * GS_LD + kk, GS_LD);
#pragma unroll
        for (int f = 0; f < NFW; ++f) {
          const int nj = (warp >> 2) + 2 * f;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(b, w2s + nj * 16 * ldw2 + kk, ldw2);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    if (nbuf == 1 && k0 + KC < Ch) {
      __syncthreads();  // every warp is done reading this chunk's buffer
      stage(k0 + KC, 0);
    }
  }

  // + b2 (+ x's centre pixel, still in the haloed patch xs, in f32) and
  // store the tile's in-image pixels
  auto finish_y = [&](int q, int c, float s) {
    s += to_f(b2[c]);
    if (residual)
      s += to_f(xs[((q / TILE + 1) * HALO + q % TILE + 1) * ldx + c]);
    return from_f<T>(s);
  };
  T* yn = y + static_cast<size_t>(n) * H * W * C;
  const int mi = warp & 3;
  float* tile_out = extra + warp * 256;
#pragma unroll
  for (int f = 0; f < NFW; ++f) {
    const int nj = (warp >> 2) + 2 * f;
    wmma::store_matrix_sync(tile_out, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int q = mi * 16 + (e >> 4);
      const int c = nj * 16 + (e & 15);
      const int gy = ty0 + q / TILE;
      const int gx = tx0 + q % TILE;
      if (gy < H && gx < W)
        yn[(static_cast<size_t>(gy) * W + gx) * C + c] =
            finish_y(q, c, tile_out[e]);
    }
    __syncwarp();
  }
}

// Two staging buffers when they fit in the device's shared memory.
int pick_nbuf(int C) {
  return layout_of(C, 2).total <= static_cast<size_t>(smem_optin_limit()) ? 2
                                                                          : 1;
}

template <int NFW>
int launch(const void* x, const void* w1, const void* b1, const void* wdw,
           const void* bdw, const void* w2, const void* b2, void* y, int N,
           int H, int W, int C, int Ch, int residual, cudaStream_t stream) {
  const int nbuf = pick_nbuf(C);
  const size_t smem = layout_of(C, nbuf).total;
  auto kernel = van_mlp_kernel<NFW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_y = (H + TILE - 1) / TILE;
  kernel<<<dim3(tiles_x * tiles_y, N), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(wdw),
      static_cast<const T*>(bdw), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), H, W, C, Ch, tiles_x,
      nbuf, residual);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 widths, one list with ops/van_mlp.py:BF16_WIDTHS: C = 32 NFW.
bool bf16_width_supported(int C) {
  if (C % 32) return false;
  switch (C / 32) {
    case 1: case 2: case 4: case 5: case 8: case 10: case 16: return true;
    default: return false;
  }
}

}  // namespace

// Bytes of shared memory one block of the kernel that takes this shape asks
// for, or 0 if the width is not supported (f32 takes any C; bf16 takes C in
// {32, 64, 128, 160, 256, 320, 512}). dtype: 0 = f32, 1 = bf16.
extern "C" size_t rs_van_mlp_smem_bytes(int C, int Ch, int dtype) {
  if (C <= 0 || Ch <= 0) return 0;
  if (dtype == 0) return van_mlp_f32_smem_bytes(C);
  if (dtype != 1 || !bf16_width_supported(C)) return 0;
  if (van_mlp_wgmma_takes(C, Ch)) return van_mlp_wgmma_smem_bytes(C);
  return layout_of(C, pick_nbuf(C)).total;
}

// Bytes of device scratch rs_van_mlp_fwd wants for this shape (0 where the
// kernel that takes it needs none).
extern "C" size_t rs_van_mlp_scratch_bytes(int C, int Ch, int dtype) {
  if (dtype == 1 && bf16_width_supported(C) && van_mlp_wgmma_takes(C, Ch))
    return van_mlp_wgmma_scratch_bytes(C, Ch);
  return 0;
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = success).
// residual != 0 writes x + mlp(x) (y must not alias x: neighbouring tiles
// read x's halo). The shape picks the design: f32 runs the f32 design
// (van_mlp_f32.cu), bf16 at the widths van_mlp_wgmma_takes() names the wgmma
// kernel (van_mlp_wgmma.cu), every other bf16 shape the kernel above.
// `scratch`: rs_van_mlp_scratch_bytes() bytes of device memory (may be null
// where that is 0).
extern "C" int rs_van_mlp_fwd(const void* x, const void* w1, const void* b1,
                              const void* wdw, const void* bdw, const void* w2,
                              const void* b2, void* y, void* scratch, int N,
                              int H, int W, int C, int Ch, int dtype,
                              int residual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || Ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return van_mlp_f32_launch(x, w1, b1, wdw, bdw, w2, b2, y, N, H, W, C, Ch,
                              residual, s);
  if (dtype != 1 || !bf16_width_supported(C))
    return static_cast<int>(cudaErrorInvalidValue);
  if (van_mlp_wgmma_takes(C, Ch))
    return van_mlp_wgmma_launch(x, w1, b1, wdw, bdw, w2, b2, y, scratch, N, H,
                                W, C, Ch, residual, s);
#define RS_VAN_MLP_CASE(k)                                                    \
  case k:                                                                     \
    return launch<k>(x, w1, b1, wdw, bdw, w2, b2, y, N, H, W, C, Ch,         \
                     residual, s);
  switch (C / 32) {
    RS_VAN_MLP_CASE(1)
    RS_VAN_MLP_CASE(2)
    RS_VAN_MLP_CASE(4)
    RS_VAN_MLP_CASE(5)
    RS_VAN_MLP_CASE(8)
    RS_VAN_MLP_CASE(10)
    RS_VAN_MLP_CASE(16)
  }
#undef RS_VAN_MLP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
