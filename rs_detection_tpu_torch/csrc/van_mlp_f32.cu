// Fused VAN MLP forward in f32 for Hopper (sm_90a): the f32 design of K2 and
// of its residual form K2r.
//
// Replaces: rs_detection_tpu/ops/pallas_van_mlp.py, `_mlp_kernel` in f32
// (reached through `van_mlp` and `van_mlp_residual`). van_mlp.cu says what the
// MLP computes and launches this design for every f32 shape, at any width.
//
// What bounds it on the H100: f32 FMAs outside the tensor cores (no TF32: the
// kernel is held to its plain version at 1e-4 of the largest output), 2 C Ch
// of them a pixel plus fc1 over the one-pixel halo, at 67 TFLOP/s; and the
// block's shared memory, which may not grow with C (VAN's widths run to 512,
// an f32 x patch of 512 channels alone is 229 KB).
//
// One block owns an 8x8 output tile of one image and up to 512 of its output
// channels (wider C is split over gridDim.z, each block computing the hidden
// chunks again). It walks the hidden channels in chunks of 32:
//   * fc1: the haloed 10x10 x patch and the chunk's w1 rows stream through
//     shared memory in slabs of 32 input channels (cp.async, two buffers, the
//     next slab in flight while one computes); each thread sums 7 haloed
//     pixels x 2 hidden channels in registers, 16-byte loads along the input
//     channels (the 7 pixel rows are the same for a quarter warp: broadcast);
//   * + b1, the hidden tensor's SAME padding, the depthwise 3x3, bdw and the
//     erf GELU through shared memory;
//   * fc2: each thread adds 8 pixels x J output channels (J <= 16, 32 J
//     channels a block: 128 registers at C = 512) from 16-byte loads along
//     the hidden channels; the chunk's w2 rows arrived while the last slab,
//     the depthwise conv and the previous fc2 ran (two buffers).
// Shared memory is 69,632 + 9,216 J bytes whatever C (217,088 at J = 16). The
// price of the bound: the x patch is read from L2 once per hidden chunk (Ch /
// 32 times), about 0.07 bytes a multiply-add.

#include "rs_common.cuh"
#include "van_mlp.cuh"

namespace {

using namespace rs;

constexpr int TILE = 8;              // output tile is TILE x TILE pixels
constexpr int HALO = TILE + 2;       // haloed tile side
constexpr int NPIX_H = HALO * HALO;  // haloed pixels
constexpr int MROWS = 112;           // haloed pixels padded to 16 x 7 rows
constexpr int NOUT = TILE * TILE;    // output pixels
constexpr int KC = 32;               // hidden channels per chunk
constexpr int CS = 32;               // input channels per slab of fc1
// row stride in floats of every staged tile: 16-byte rows, and eight
// consecutive rows start in eight different 16-byte bank groups
constexpr int LD = CS + 4;
constexpr int THREADS = 256;
constexpr int PX1 = MROWS / 16;      // fc1: haloed pixels of one thread
constexpr int PX2 = NOUT / 8;        // fc2: output pixels of one thread

struct Layout {
  size_t xs, w1s, w2s, vs, hs, gs, total;
  size_t xs_buf, w1s_buf, w2s_buf, vs_buf;  // bytes between the buffers
};

// `vs` holds a chunk's b1, bdw and 3x3 taps; every part is a multiple of 16
// bytes, so every row stays 16-byte aligned.
__host__ __device__ inline Layout layout_of(int J) {
  Layout l;
  size_t o = 0;
  l.xs_buf = static_cast<size_t>(MROWS) * LD * 4;
  l.xs = o;
  o += 2 * l.xs_buf;
  l.w1s_buf = static_cast<size_t>(KC) * LD * 4;
  l.w1s = o;
  o += 2 * l.w1s_buf;
  l.w2s_buf = static_cast<size_t>(32 * J) * LD * 4;
  l.w2s = o;
  o += 2 * l.w2s_buf;
  l.vs_buf = static_cast<size_t>(KC) * 11 * 4;
  l.vs = o;
  o += 2 * l.vs_buf;
  l.hs = o;
  o += static_cast<size_t>(MROWS) * LD * 4;
  l.gs = o;
  o += static_cast<size_t>(NOUT) * LD * 4;
  l.total = o;
  return l;
}

// One 4-byte cp.async (src == nullptr zero-fills; `any_valid` as cp_async16).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          const void* any_valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src ? static_cast<const void*>(src) : any_valid),
               "r"(src ? 4 : 0)
               : "memory");
}

// Starts copies of `rows` rows of 32 floats into dst (row stride LD): row r
// from row_of(r, valid), whose first `valid` floats are real and the rest
// zero (nullptr: all zero). `vec`: 16-byte copies, where every source row and
// `valid` are multiples of 4 floats.
template <typename RowOf>
__device__ __forceinline__ void stage_rows(float* dst, int rows, int vec,
                                           const void* any_valid,
                                           RowOf row_of) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * 8; i += THREADS) {
      const int r = i >> 3, e = (i & 7) * 4;
      int valid = 0;
      const float* src = row_of(r, valid);
      cp_async16(dst + r * LD + e, src != nullptr && e < valid ? src + e
                                                               : nullptr,
                 any_valid);
    }
  } else {
    for (int i = threadIdx.x; i < rows * 32; i += THREADS) {
      const int r = i >> 5, e = i & 31;
      int valid = 0;
      const float* src = row_of(r, valid);
      cp_async4(dst + r * LD + e, src != nullptr && e < valid ? src + e
                                                              : nullptr,
                any_valid);
    }
  }
}

template <int J>
__global__ void __launch_bounds__(THREADS, J <= 4 ? 2 : 1)
    van_mlp_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ wdw,
                       const float* __restrict__ bdw,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2, float* __restrict__ y,
                       int H, int W, int C, int Ch, int tiles_x, int vec,
                       int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_of(J);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* gs = reinterpret_cast<float*>(smem + L.gs);
  auto xbuf = [&](int b) {
    return reinterpret_cast<float*>(smem + L.xs + b * L.xs_buf);
  };
  auto w1buf = [&](int b) {
    return reinterpret_cast<float*>(smem + L.w1s + b * L.w1s_buf);
  };
  auto w2buf = [&](int b) {
    return reinterpret_cast<float*>(smem + L.w2s + b * L.w2s_buf);
  };
  auto vsbuf = [&](int b) {
    return reinterpret_cast<float*>(smem + L.vs + b * L.vs_buf);
  };

  const int n = blockIdx.y;
  const int c0 = blockIdx.z * 32 * J;  // the block's first output channel
  const int ty0 = (blockIdx.x / tiles_x) * TILE;
  const int tx0 = (blockIdx.x % tiles_x) * TILE;
  const int tid = threadIdx.x;
  const float* xn = x + static_cast<size_t>(n) * H * W * C;
  const int ns = (C + CS - 1) / CS;    // slabs of a chunk
  const int nk = (Ch + KC - 1) / KC;   // hidden chunks
  const int steps = nk * ns;

  // step t = slab t % ns of chunk t / ns: the haloed patch's input channels
  // [s0, s0 + CS) (zero outside the image and in the padding rows) and the
  // chunk's w1 rows over them (zero past Ch), into buffer t & 1
  auto stage_slab = [&](int t) {
    const int k0 = (t / ns) * KC, s0 = (t % ns) * CS;
    const int valid = min(CS, C - s0);
    stage_rows(xbuf(t & 1), MROWS, vec, x,
               [&](int p, int& v) -> const float* {
                 v = valid;
                 const int gy = ty0 - 1 + p / HALO;
                 const int gx = tx0 - 1 + p % HALO;
                 if (p >= NPIX_H || gy < 0 || gy >= H || gx < 0 || gx >= W)
                   return nullptr;
                 return xn + (static_cast<size_t>(gy) * W + gx) * C + s0;
               });
    stage_rows(w1buf(t & 1), KC, vec, x,
               [&](int j, int& v) -> const float* {
                 v = valid;
                 return k0 + j < Ch ? w1 + static_cast<size_t>(k0 + j) * C + s0
                                    : nullptr;
               });
  };
  // chunk k's w2 columns for the block's output channels, b1, bdw and taps
  // (zero past Ch and past C), into buffer k & 1
  auto stage_chunk = [&](int k) {
    const int k0 = k * KC;
    const int valid = min(KC, Ch - k0);
    stage_rows(w2buf(k & 1), 32 * J, vec, x,
               [&](int r, int& v) -> const float* {
                 v = valid;
                 return c0 + r < C ? w2 + static_cast<size_t>(c0 + r) * Ch + k0
                                   : nullptr;
               });
    float* vs = vsbuf(k & 1);
    for (int i = tid; i < KC * 11; i += THREADS) {
      const int j = i < 2 * KC ? i % KC : (i - 2 * KC) / 9;
      const float* src = nullptr;
      if (k0 + j < Ch)
        src = i < KC ? b1 + k0 + j
            : i < 2 * KC ? bdw + k0 + j
                         : wdw + static_cast<size_t>(k0) * 9 + (i - 2 * KC);
      cp_async4(vs + i, src, x);
    }
  };

  const int pg = tid >> 4, cg = tid & 15;  // fc1: pixels pg * 7 + i, hidden cg, cg + 16
  const int qg = tid & 7, og = tid >> 3;   // fc2: pixels qg + 8 i, channels c0 + og + 32 jj
  float acc[PX2][J];
#pragma unroll
  for (int i = 0; i < PX2; ++i)
#pragma unroll
    for (int jj = 0; jj < J; ++jj) acc[i][jj] = 0.f;
  float h[PX1][2];

  stage_chunk(0);
  stage_slab(0);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    const int k = t / ns, s = t - k * ns;
    cp_async_wait_all();
    // slab t (and on a chunk's first slab its weights) is in shared memory,
    // and every thread is done with the buffers the copies below refill
    __syncthreads();
    if (s == ns - 1 && k + 1 < nk) stage_chunk(k + 1);
    if (t + 1 < steps) stage_slab(t + 1);
    cp_async_commit();

    if (s == 0) {
#pragma unroll
      for (int i = 0; i < PX1; ++i) h[i][0] = h[i][1] = 0.f;
    }
    {
      const float* xr = xbuf(t & 1) + pg * PX1 * LD;
      const float* wr = w1buf(t & 1) + cg * LD;
#pragma unroll
      for (int c4 = 0; c4 < CS; c4 += 4) {
        const float4 wa = *reinterpret_cast<const float4*>(wr + c4);
        const float4 wb = *reinterpret_cast<const float4*>(wr + 16 * LD + c4);
#pragma unroll
        for (int i = 0; i < PX1; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(xr + i * LD + c4);
          h[i][0] = fmaf(v.x, wa.x, h[i][0]);
          h[i][0] = fmaf(v.y, wa.y, h[i][0]);
          h[i][0] = fmaf(v.z, wa.z, h[i][0]);
          h[i][0] = fmaf(v.w, wa.w, h[i][0]);
          h[i][1] = fmaf(v.x, wb.x, h[i][1]);
          h[i][1] = fmaf(v.y, wb.y, h[i][1]);
          h[i][1] = fmaf(v.z, wb.z, h[i][1]);
          h[i][1] = fmaf(v.w, wb.w, h[i][1]);
        }
      }
    }
    if (s != ns - 1) continue;

    // the chunk's fc1 is summed: + b1, zero in the hidden tensor's SAME
    // padding (fc1 of a padded zero is b1, not 0)
    const float* vs = vsbuf(k & 1);
#pragma unroll
    for (int i = 0; i < PX1; ++i) {
      const int p = pg * PX1 + i;
      const int gy = ty0 - 1 + p / HALO;
      const int gx = tx0 - 1 + p % HALO;
      const bool in = p < NPIX_H && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        hs[p * LD + cg + 16 * e] = in ? h[i][e] + vs[cg + 16 * e] : 0.f;
    }
    __syncthreads();

    // depthwise 3x3 + bdw + erf gelu; channels past Ch have zero taps and
    // bias, so they give gelu(0) = 0
    for (int i = tid; i < NOUT * KC; i += THREADS) {
      const int q = i >> 5, j = i & 31;
      const int qy = q / TILE, qx = q % TILE;
      const float* wt = vs + 2 * KC + j * 9;
      float a = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          a = fmaf(hs[((qy + dy) * HALO + qx + dx) * LD + j], wt[dy * 3 + dx],
                   a);
      gs[q * LD + j] = gelu_erf(a + vs[KC + j]);
    }
    __syncthreads();

    // fc2: acc[i][jj] += sum_j g[qg + 8 i][j] w2[c0 + og + 32 jj][k0 + j]
    const float* gr = gs + qg * LD;
    const float* wr = w2buf(k & 1) + og * LD;
#pragma unroll 2
    for (int j4 = 0; j4 < KC; j4 += 4) {
      float4 g[PX2];
#pragma unroll
      for (int i = 0; i < PX2; ++i)
        g[i] = *reinterpret_cast<const float4*>(gr + i * 8 * LD + j4);
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float4 w = *reinterpret_cast<const float4*>(wr + jj * 32 * LD + j4);
#pragma unroll
        for (int i = 0; i < PX2; ++i) {
          acc[i][jj] = fmaf(g[i].x, w.x, acc[i][jj]);
          acc[i][jj] = fmaf(g[i].y, w.y, acc[i][jj]);
          acc[i][jj] = fmaf(g[i].z, w.z, acc[i][jj]);
          acc[i][jj] = fmaf(g[i].w, w.w, acc[i][jj]);
        }
      }
    }
  }

  // + b2 (+ x, read again from global memory, in f32) and store the tile's
  // in-image pixels
  float* yn = y + static_cast<size_t>(n) * H * W * C;
#pragma unroll
  for (int i = 0; i < PX2; ++i) {
    const int q = qg + 8 * i;
    const int gy = ty0 + q / TILE;
    const int gx = tx0 + q % TILE;
    if (gy >= H || gx >= W) continue;
    const size_t at = (static_cast<size_t>(gy) * W + gx) * C;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      const int c = c0 + og + 32 * jj;
      if (c >= C) continue;
      float v = acc[i][jj] + b2[c];
      if (residual) v += xn[at + c];
      yn[at + c] = v;
    }
  }
}

template <int J>
int launch(const void* x, const void* w1, const void* b1, const void* wdw,
           const void* bdw, const void* w2, const void* b2, void* y, int N,
           int H, int W, int C, int Ch, int residual, cudaStream_t stream) {
  const size_t smem = layout_of(J).total;
  auto kernel = van_mlp_f32_kernel<J>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_y = (H + TILE - 1) / TILE;
  const int vec =
      C % 4 == 0 && Ch % 4 == 0 &&
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w1) |
        reinterpret_cast<size_t>(w2)) & 15) == 0;
  kernel<<<dim3(tiles_x * tiles_y, N, van_mlp_f32_splits(C)), THREADS, smem,
           stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wdw),
      static_cast<const float*>(bdw), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), H, W, C, Ch,
      tiles_x, vec, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace rs {

size_t van_mlp_f32_smem_bytes(int C) {
  return layout_of(van_mlp_f32_slots(C)).total;
}

int van_mlp_f32_launch(const void* x, const void* w1, const void* b1,
                       const void* wdw, const void* bdw, const void* w2,
                       const void* b2, void* y, int N, int H, int W, int C,
                       int Ch, int residual, cudaStream_t stream) {
#define RS_VAN_MLP_F32_CASE(j)                                               \
  case j:                                                                    \
    return launch<j>(x, w1, b1, wdw, bdw, w2, b2, y, N, H, W, C, Ch,        \
                     residual, stream);
  switch (van_mlp_f32_slots(C)) {
    RS_VAN_MLP_F32_CASE(1)
    RS_VAN_MLP_F32_CASE(2)
    RS_VAN_MLP_F32_CASE(4)
    RS_VAN_MLP_F32_CASE(5)
    RS_VAN_MLP_F32_CASE(8)
    RS_VAN_MLP_F32_CASE(10)
    RS_VAN_MLP_F32_CASE(16)
  }
#undef RS_VAN_MLP_F32_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rs
