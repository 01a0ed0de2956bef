// Fused VAN MLP forward, the int8 serving form, for Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_van_mlp.py, `_mlp_kernel` with
// `quant=True` (`_qdot`, :101). van_mlp.cu says what the MLP computes and
// holds the float kernel this one is built like: a block owns an 8x8 output
// tile, loads its haloed patch once and walks the hidden channels in chunks
// of 32 (TILE, HALO, MROWS and KC below are that kernel's, repeated here so
// that the two sources build side by side).
//
// `rs_van_mlp_int8_fwd` takes the float weights and the float kernel's
// `residual` flag, quantizes the weights per output channel on the card and
// picks the design by shape: bf16 at the widths van_mlp_q_wgmma_takes() names
// runs the wgmma design (van_mlp_int8_wgmma.cu), every other shape
// `van_mlp_q_kernel` below: the first design in bf16 (C = 32 and 160), the
// f32 design in f32 (any C).
// Both 1x1 products run s8 x s8 -> s32 (WMMA 16x16x16 `signed char` fragments
// with `int` accumulators in bf16, dp4a in f32); the depthwise 3x3 and the
// GELU stay in f32. In f32 the fc2 sums live in registers as in the float
// form's f32 design (van_mlp_f32.cu, van_mlp_f32_slots): a thread holds 8
// output pixels x J channels, a block 32 J (at most 512, C wider than that is
// split over gridDim.z), so shared memory stays bounded (the s8 patch grows
// with C, 116 KB at C = 1024, and one staging buffer is kept where two do not
// fit). The weights are quantized per
// output channel by `quantize_rows_kernel`, bit for bit as ops/quant.py:
// qweight does (w1q [Ch, C] s8 with sw1 [Ch] f32, w2q [C, Ch] s8 with sw2 [C]
// f32, in the launch's scratch); the activations are quantized here, dynamically and
// symmetrically, `q = clip(rint(v * (1 / s)), -127, 127)` with `s = max|v| /
// 127` (1 where the group is all zero), the TPU kernel's arithmetic. The
// group of an activation scale is what a block holds, not the TPU's row
// block:
//   fc1: one scale per tile, over its 10x10 haloed x patch (zero outside the
//        image), over all C whatever block of output channels a block makes.
//        The patch is read twice from global memory (max, then quantize into
//        shared memory as s8), because a bf16 copy beside the s8 one does not
//        fit at C = 512; the residual's x comes from global memory at the end
//        for the same reason.
//   fc2: one scale per (tile, 32-channel hidden chunk), over the f32 GELU
//        output of the tile's in-image pixels. The kernel never holds a
//        tile's whole hidden tensor (64 x 2048 values at stage 4), so a scale
//        over all hidden channels would need a second pass over the chunks
//        (fc1, dw and GELU computed twice); per chunk it stays one pass: each
//        chunk's s32 product is scaled by its `sg` into the f32 accumulators,
//        and sw2, which does not depend on the chunk, multiplies once at the
//        end. Pixels of a border tile outside the image are left out of the
//        scale (the TPU kernel lets its padded rows in).
// h1 is dequantized as `acc * (sx * sw1) + b1` and rounded to the input
// dtype, zero outside the image; y = (sum_k sg_k * acc_k) * sw2 + b2 (+ x),
// one cast. The dequantizing multiplies and adds are written with
// __fmul_rn / __fadd_rn so that the compiler contracts none of them into an
// FMA and the plain version (`van_mlp_int8_reference`, group "tile") can
// repeat them bit for bit ahead of the next quantizer.

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

constexpr int GQ_LD = KC + 16;  // s8 row stride of the gelu and w2 chunks
constexpr int G_PER_THREAD = NOUT * KC / THREADS;

// s8 row stride of the x patch and the w1 chunk: WMMA wants a multiple of 16
// bytes; the 16 more spread eight rows over all 32 banks
__host__ __device__ constexpr int ld_q(int c) {
  return (c + 15) / 16 * 16 + 16;
}

struct QLayout {
  size_t xq, w1q, w2q, vs, sw, hs, gq, red, extra, total;
  size_t w1q_buf, w2q_buf, vs_buf, sw_buf;  // bytes between staging buffers
};

// `vs` holds a chunk's b1, bdw and 3x3 taps (T), `sw` its sw1 (f32); `hs` the
// fc1 chunk, first as s32 sums and then as f32 values; `red` the block
// reduction's per-warp maxima; `extra` the per-warp output staging tiles
// (bf16; none in f32, whose sums stay in registers). `rows2`: the w2q rows a
// chunk stages, C in bf16 and the block's 32 J output channels in f32.
template <typename T>
__host__ __device__ inline QLayout qlayout_of(int c, int nbuf, int rows2) {
  QLayout l;
  size_t o = 0;
  l.xq = o;
  o += up128(static_cast<size_t>(MROWS) * ld_q(c));
  l.w1q_buf = up128(static_cast<size_t>(KC) * ld_q(c));
  l.w1q = o;
  o += nbuf * l.w1q_buf;
  l.w2q_buf = up128(static_cast<size_t>(rows2) * GQ_LD);
  l.w2q = o;
  o += nbuf * l.w2q_buf;
  l.vs_buf = up128(static_cast<size_t>(KC) * 11 * sizeof(T));
  l.vs = o;
  o += nbuf * l.vs_buf;
  l.sw_buf = up128(static_cast<size_t>(KC) * sizeof(float));
  l.sw = o;
  o += nbuf * l.sw_buf;
  l.hs = o;
  o += up128(static_cast<size_t>(MROWS) * HS_LD * sizeof(float));
  l.gq = o;
  o += up128(static_cast<size_t>(NOUT) * GQ_LD);
  l.red = o;
  o += up128(static_cast<size_t>(WARPS) * sizeof(float));
  l.extra = o;
  o += sizeof(T) == 2 ? up128(static_cast<size_t>(WARPS) * 256 * sizeof(float))
                      : 0;
  l.total = o;
  return l;
}

// w2q rows a chunk stages: all C in bf16, the block's channels in f32
template <typename T, int NFW> __host__ __device__ constexpr int rows2_of(int c) {
  return sizeof(T) == 2 ? c : 32 * NFW;
}

// Max of v (>= 0) over the block, returned to every thread. `red` holds one
// float per warp; a block barrier must lie between two calls.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) m = fmaxf(m, red[i]);
  return m;
}

// scale of a group with largest magnitude amax; its reciprocal quantizes
__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}
__device__ __forceinline__ signed char quant8(float v, float inv) {
  return static_cast<signed char>(__float2int_rn(
      fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f)));
}

// NFW: in bf16 the fc2 accumulator fragments per warp (C = 32 NFW); in f32
// the output channels per thread (J of van_mlp_f32_slots).
template <typename T, int NFW>
__global__ void __launch_bounds__(THREADS, NFW <= 2 ? 3 : NFW <= 4 ? 2 : 1)
    van_mlp_q_kernel(const T* __restrict__ x,
                     const signed char* __restrict__ w1q,
                     const float* __restrict__ sw1, const T* __restrict__ b1,
                     const T* __restrict__ wdw, const T* __restrict__ bdw,
                     const signed char* __restrict__ w2q,
                     const float* __restrict__ sw2, const T* __restrict__ b2,
                     T* __restrict__ y, int H, int W, int C, int Ch,
                     int tiles_x, int nbuf, int residual) {
  using namespace nvcuda;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const QLayout L = qlayout_of<T>(C, nbuf, rows2_of<T, NFW>(C));
  signed char* xq = reinterpret_cast<signed char*>(smem + L.xq);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  signed char* gq = reinterpret_cast<signed char*>(smem + L.gq);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* extra = reinterpret_cast<float*>(smem + L.extra);

  const int ldq = ld_q(C);
  const int cw = (C + 15) / 16 * 16;     // the dp4a loops' 16-byte end
  const int c0 = blockIdx.z * 32 * NFW;  // f32: the block's first channel
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE;
  const int tx0 = (blockIdx.x % tiles_x) * TILE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* xn = x + static_cast<size_t>(n) * H * W * C;

  // stage hidden chunk [k0, k0 + KC) of w1q, w2q, sw1, b1, bdw, wdw
  auto stage = [&](int k0, int buf) {
    signed char* w1s =
        reinterpret_cast<signed char*>(smem + L.w1q + buf * L.w1q_buf);
    signed char* w2s =
        reinterpret_cast<signed char*>(smem + L.w2q + buf * L.w2q_buf);
    T* vs = reinterpret_cast<T*>(smem + L.vs + buf * L.vs_buf);
    float* sws = reinterpret_cast<float*>(smem + L.sw + buf * L.sw_buf);
    if (kBf16 && Ch % KC == 0) {
      // whole chunks: rows of w1q and row segments of w2q in 16-byte vectors
      const int vpr = C / 16;
      copy_vec16(
          KC * vpr, w1q,
          [&](int i) {
            const int j = i / vpr;
            return w1q + static_cast<size_t>(k0 + j) * C + (i - j * vpr) * 16;
          },
          [&](int i) {
            const int j = i / vpr;
            return w1s + j * ldq + (i - j * vpr) * 16;
          });
      copy_vec16(
          C * (KC / 16), w2q,
          [&](int i) {
            return w2q + static_cast<size_t>(i / (KC / 16)) * Ch + k0 +
                   (i % (KC / 16)) * 16;
          },
          [&](int i) {
            return w2s + (i / (KC / 16)) * GQ_LD + (i % (KC / 16)) * 16;
          });
      copy_vec16(
          KC * 11 / 8, b1,
          [&](int i) {
            return i < KC / 8 ? b1 + k0 + i * 8
                 : i < KC / 4 ? bdw + k0 + (i - KC / 8) * 8
                              : wdw + static_cast<size_t>(k0) * 9 +
                                    (i - KC / 4) * 8;
          },
          [&](int i) { return vs + i * 8; });
      copy_vec16(
          KC / 4, sw1, [&](int i) { return sw1 + k0 + i * 4; },
          [&](int i) { return sws + i * 4; });
    } else {
      // zero past Ch and past C up to the dp4a loops' 16-byte end; w2q rows
      // of the block's output channels
      for (int i = tid; i < KC * cw; i += THREADS) {
        const int j = i / cw;
        const int c = i - j * cw;
        w1s[j * ldq + c] = k0 + j < Ch && c < C
                               ? w1q[static_cast<size_t>(k0 + j) * C + c]
                               : 0;
      }
      const int rows2 = rows2_of<T, NFW>(C);
      for (int i = tid; i < rows2 * KC; i += THREADS) {
        const int r = i / KC;
        const int j = i - r * KC;
        w2s[r * GQ_LD + j] =
            k0 + j < Ch && c0 + r < C
                ? w2q[static_cast<size_t>(c0 + r) * Ch + k0 + j]
                : 0;
      }
      for (int i = tid; i < KC * 11; i += THREADS) {
        const int j = i < 2 * KC ? i % KC : (i - 2 * KC) / 9;
        T v = from_f<T>(0.f);
        if (k0 + j < Ch)
          v = i < KC ? b1[k0 + j]
            : i < 2 * KC ? bdw[k0 + j]
                         : wdw[static_cast<size_t>(k0) * 9 + (i - 2 * KC)];
        vs[i] = v;
      }
      for (int j = tid; j < KC; j += THREADS)
        sws[j] = k0 + j < Ch ? sw1[k0 + j] : 1.f;
    }
  };
  stage(0, 0);  // in flight while the patch is read

  // address of haloed pixel p in the image, or nullptr outside it
  auto pixel = [&](int p) -> const T* {
    const int gy = ty0 - 1 + p / HALO;
    const int gx = tx0 - 1 + p % HALO;
    if (p >= NPIX_H || gy < 0 || gy >= H || gx < 0 || gx >= W) return nullptr;
    return xn + (static_cast<size_t>(gy) * W + gx) * C;
  };

  // pass 1: the patch's largest magnitude
  float amax = 0.f;
  if constexpr (kBf16) {
    const int vpp = C / 8;  // 16-byte vectors per pixel
    for (int i = tid; i < NPIX_H * vpp; i += THREADS) {
      const int p = i / vpp;
      const T* src = pixel(p);
      if (src == nullptr) continue;
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(src + (i - p * vpp) * 8));
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(to_f(e[k])));
    }
  } else {
    for (int i = tid; i < NPIX_H * C; i += THREADS) {
      const int p = i / C;
      const T* src = pixel(p);
      if (src != nullptr) amax = fmaxf(amax, fabsf(to_f(src[i - p * C])));
    }
  }
  amax = block_max(amax, red);
  const float sx = scale_of(amax);
  const float xinv = __fdiv_rn(1.f, sx);

  // pass 2: the patch as s8; zero outside the image and in the padding rows
  if constexpr (kBf16) {
    const int vpp = C / 8;
    for (int i = tid; i < MROWS * vpp; i += THREADS) {
      const int p = i / vpp;
      const T* src = pixel(p);
      uint2 out = make_uint2(0u, 0u);
      if (src != nullptr) {
        const uint4 v =
            __ldg(reinterpret_cast<const uint4*>(src + (i - p * vpp) * 8));
        const T* e = reinterpret_cast<const T*>(&v);
        signed char* o = reinterpret_cast<signed char*>(&out);
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = quant8(to_f(e[k]), xinv);
      }
      *reinterpret_cast<uint2*>(xq + p * ldq + (i - p * vpp) * 8) = out;
    }
  } else {
    for (int i = tid; i < MROWS * cw; i += THREADS) {
      const int p = i / cw;
      const int c = i - p * cw;
      const T* src = pixel(p);
      xq[p * ldq + c] = src != nullptr && c < C ? quant8(to_f(src[c]), xinv)
                                                : 0;
    }
  }

  // bf16: the fc2 sums in fragments; f32: 8 pixels x NFW channels a thread
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBf16 ? NFW : 1];
#pragma unroll
  for (int f = 0; f < (kBf16 ? NFW : 0); ++f) wmma::fill_fragment(acc[f], 0.f);
  constexpr int PX2 = kBf16 ? 1 : NOUT / 8;
  float acc2[PX2][kBf16 ? 1 : NFW];
#pragma unroll
  for (int i = 0; i < PX2; ++i)
#pragma unroll
    for (int jj = 0; jj < (kBf16 ? 1 : NFW); ++jj) acc2[i][jj] = 0.f;

  for (int k0 = 0, it = 0; k0 < Ch; k0 += KC, ++it) {
    const int buf = nbuf == 2 ? (it & 1) : 0;
    cp_async_wait_all();
    // chunk k0 and (first time round) xq are in shared memory, and every
    // warp is done with the previous chunk
    __syncthreads();
    if (nbuf == 2 && k0 + KC < Ch) stage(k0 + KC, buf ^ 1);
    const signed char* w1s =
        reinterpret_cast<const signed char*>(smem + L.w1q + buf * L.w1q_buf);
    const signed char* w2s =
        reinterpret_cast<const signed char*>(smem + L.w2q + buf * L.w2q_buf);
    const T* vb1 = reinterpret_cast<const T*>(smem + L.vs + buf * L.vs_buf);
    const T* vbdw = vb1 + KC;
    const T* vwdw = vbdw + KC;  // [KC][9]
    const float* vsw1 =
        reinterpret_cast<const float*>(smem + L.sw + buf * L.sw_buf);

    // dequantize the s32 sum of haloed pixel p and chunk channel j, + b1,
    // round to the input dtype, zero in the hidden tensor's SAME padding
    auto finish_h1 = [&](int p, int j, int s) {
      const int gy = ty0 - 1 + p / HALO;
      const int gx = tx0 - 1 + p % HALO;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float v = __fadd_rn(
          __fmul_rn(static_cast<float>(s), __fmul_rn(sx, vsw1[j])),
          to_f(vb1[j]));
      return in ? round_to<T>(v) : 0.f;
    };

    // fc1: hs[p][j] = h1(sum_c xq[p][c] w1q[j][c])
    if constexpr (kBf16) {
      for (int mi = warp; mi < MROWS / 16; mi += WARPS) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> h0, h1;
        wmma::fill_fragment(h0, 0);
        wmma::fill_fragment(h1, 0);
        for (int kk = 0; kk < C; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                         wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                         wmma::col_major> b;
          wmma::load_matrix_sync(a, xq + mi * 16 * ldq + kk, ldq);
          wmma::load_matrix_sync(b, w1s + kk, ldq);
          wmma::mma_sync(h0, a, b, h0);
          wmma::load_matrix_sync(b, w1s + 16 * ldq + kk, ldq);
          wmma::mma_sync(h1, a, b, h1);
        }
        float* hrow = hs + mi * 16 * HS_LD;
        int* irow = reinterpret_cast<int*>(hrow);
        wmma::store_matrix_sync(irow, h0, HS_LD, wmma::mem_row_major);
        wmma::store_matrix_sync(irow + 16, h1, HS_LD, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * KC; e += 32) {
          const int p = mi * 16 + e / KC;
          const int j = e % KC;
          float* slot = hrow + (e / KC) * HS_LD + j;
          if (p < NPIX_H) *slot = finish_h1(p, j, __float_as_int(*slot));
        }
      }
    } else {
      // 7 haloed pixels x 2 hidden channels a thread, four products a dp4a,
      // 16-byte loads along the input channels (a quarter warp reads the
      // same pixel rows: a broadcast)
      const int pg = tid >> 4, cg = tid & 15;
      int hsum[MROWS / 16][2] = {};
      const signed char* xr = xq + pg * (MROWS / 16) * ldq;
      const signed char* wr = w1s + cg * ldq;
      for (int c = 0; c < cw; c += 16) {
        const int4 wa = *reinterpret_cast<const int4*>(wr + c);
        const int4 wb = *reinterpret_cast<const int4*>(wr + 16 * ldq + c);
#pragma unroll
        for (int i = 0; i < MROWS / 16; ++i) {
          const int4 v = *reinterpret_cast<const int4*>(xr + i * ldq + c);
          hsum[i][0] = __dp4a(v.x, wa.x, hsum[i][0]);
          hsum[i][0] = __dp4a(v.y, wa.y, hsum[i][0]);
          hsum[i][0] = __dp4a(v.z, wa.z, hsum[i][0]);
          hsum[i][0] = __dp4a(v.w, wa.w, hsum[i][0]);
          hsum[i][1] = __dp4a(v.x, wb.x, hsum[i][1]);
          hsum[i][1] = __dp4a(v.y, wb.y, hsum[i][1]);
          hsum[i][1] = __dp4a(v.z, wb.z, hsum[i][1]);
          hsum[i][1] = __dp4a(v.w, wb.w, hsum[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < MROWS / 16; ++i) {
        const int p = pg * (MROWS / 16) + i;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (p < NPIX_H)
            hs[p * HS_LD + cg + 16 * e] = finish_h1(p, cg + 16 * e, hsum[i][e]);
      }
    }
    __syncthreads();

    // depthwise 3x3 + bdw + erf gelu in f32, kept in registers; zero at the
    // pixels of a border tile outside the image; then the chunk's scale
    float gv[G_PER_THREAD];
    float gmax = 0.f;
#pragma unroll
    for (int r = 0; r < G_PER_THREAD; ++r) {
      const int i = tid + r * THREADS;
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
      const bool in = ty0 + qy < H && tx0 + qx < W;
      gv[r] = in ? gelu_erf(a + to_f(vbdw[j])) : 0.f;
      gmax = fmaxf(gmax, fabsf(gv[r]));
    }
    gmax = block_max(gmax, red);
    const float sg = scale_of(gmax);
    const float ginv = __fdiv_rn(1.f, sg);
#pragma unroll
    for (int r = 0; r < G_PER_THREAD; ++r) {
      const int i = tid + r * THREADS;
      gq[(i / KC) * GQ_LD + i % KC] = quant8(gv[r], ginv);
    }
    __syncthreads();

    // fc2: y[q][c] += sg * sum_j gq[q][j] w2q[c][k0 + j]
    if constexpr (kBf16) {
      const int mi = warp & 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a0, a1;
      wmma::load_matrix_sync(a0, gq + mi * 16 * GQ_LD, GQ_LD);
      wmma::load_matrix_sync(a1, gq + mi * 16 * GQ_LD + 16, GQ_LD);
#pragma unroll
      for (int f = 0; f < NFW; ++f) {
        const int nj = (warp >> 2) + 2 * f;
        wmma::fragment<wmma::accumulator, 16, 16, 16, int> part;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major> b;
        wmma::fill_fragment(part, 0);
        wmma::load_matrix_sync(b, w2s + nj * 16 * GQ_LD, GQ_LD);
        wmma::mma_sync(part, a0, b, part);
        wmma::load_matrix_sync(b, w2s + nj * 16 * GQ_LD + 16, GQ_LD);
        wmma::mma_sync(part, a1, b, part);
        // s32 and f32 accumulator fragments of one shape hold the same
        // elements in the same slots
#pragma unroll
        for (int t = 0; t < part.num_elements; ++t)
          acc[f].x[t] = __fadd_rn(
              acc[f].x[t], __fmul_rn(sg, static_cast<float>(part.x[t])));
      }
    } else {
      // a channel's s32 sum over the chunk (eight dp4a a pixel), then scaled
      // by sg into its f32 accumulator
      const int qg = tid & 7, og = tid >> 3;
#pragma unroll
      for (int jj = 0; jj < NFW; ++jj) {
        const signed char* wr = w2s + (og + 32 * jj) * GQ_LD;
        const int4 wa = *reinterpret_cast<const int4*>(wr);
        const int4 wb = *reinterpret_cast<const int4*>(wr + 16);
#pragma unroll
        for (int i = 0; i < PX2; ++i) {
          const signed char* gr = gq + (qg + 8 * i) * GQ_LD;
          const int4 ga = *reinterpret_cast<const int4*>(gr);
          const int4 gb = *reinterpret_cast<const int4*>(gr + 16);
          int s = __dp4a(ga.x, wa.x, 0);
          s = __dp4a(ga.y, wa.y, s);
          s = __dp4a(ga.z, wa.z, s);
          s = __dp4a(ga.w, wa.w, s);
          s = __dp4a(gb.x, wb.x, s);
          s = __dp4a(gb.y, wb.y, s);
          s = __dp4a(gb.z, wb.z, s);
          s = __dp4a(gb.w, wb.w, s);
          acc2[i][jj] = __fadd_rn(acc2[i][jj],
                                  __fmul_rn(sg, static_cast<float>(s)));
        }
      }
    }
    if (nbuf == 1 && k0 + KC < Ch) {
      __syncthreads();  // every warp is done reading this chunk's buffer
      stage(k0 + KC, 0);
    }
  }

  // * sw2 + b2 (+ x, read again from global memory, in f32) and store the
  // tile's in-image pixels
  T* yn = y + static_cast<size_t>(n) * H * W * C;
  auto finish_y = [&](size_t at, int c, float s) {
    s = __fadd_rn(__fmul_rn(s, sw2[c]), to_f(b2[c]));
    if (residual) s = __fadd_rn(s, to_f(xn[at]));
    return from_f<T>(s);
  };
  if constexpr (kBf16) {
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
        if (gy < H && gx < W) {
          const size_t at = (static_cast<size_t>(gy) * W + gx) * C + c;
          yn[at] = finish_y(at, c, tile_out[e]);
        }
      }
      __syncwarp();
    }
  } else {
    const int qg = tid & 7, og = tid >> 3;
#pragma unroll
    for (int i = 0; i < PX2; ++i) {
      const int q = qg + 8 * i;
      const int gy = ty0 + q / TILE;
      const int gx = tx0 + q % TILE;
      if (gy >= H || gx >= W) continue;
#pragma unroll
      for (int jj = 0; jj < NFW; ++jj) {
        const int c = c0 + og + 32 * jj;
        if (c >= C) continue;
        const size_t at = (static_cast<size_t>(gy) * W + gx) * C + c;
        yn[at] = finish_y(at, c, acc2[i][jj]);
      }
    }
  }
}

template <typename T, int NFW> int pick_qnbuf(int C) {
  return qlayout_of<T>(C, 2, rows2_of<T, NFW>(C)).total <=
                 static_cast<size_t>(smem_optin_limit())
             ? 2
             : 1;
}
template <typename T, int NFW> size_t qsmem_of(int C) {
  return qlayout_of<T>(C, pick_qnbuf<T, NFW>(C), rows2_of<T, NFW>(C)).total;
}

// Where the first design keeps its quantized weights in the scratch: w1q
// [Ch, C] and w2q [C, Ch] s8, then sw1 [Ch] and sw2 [C] f32.
struct QScratch {
  size_t w1q, w2q, sw1, sw2, total;
};
QScratch qscratch_of(int C, int Ch) {
  QScratch s;
  const size_t n = static_cast<size_t>(C) * Ch;
  s.w1q = 0;
  s.w2q = (n + 15) / 16 * 16;
  s.sw1 = s.w2q + (n + 15) / 16 * 16;
  s.sw2 = s.sw1 + (static_cast<size_t>(Ch) * 4 + 15) / 16 * 16;
  s.total = s.sw2 + static_cast<size_t>(C) * 4;
  return s;
}

// Quantizes the rows of w [rows, len] as ops/quant.py:qweight does: scale =
// amax / 127 by a true divide (1 where the row is zero), q = clip(rint(w /
// scale)) by a true divide. One warp per row.
template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ w, int rows,
                                     int len, signed char* __restrict__ q,
                                     float* __restrict__ scale) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* src = w + static_cast<size_t>(row) * len;
  float amax = 0.f;
  for (int i = lane; i < len; i += 32) amax = fmaxf(amax, fabsf(to_f(src[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = scale_of(amax);
  for (int i = lane; i < len; i += 32)
    q[static_cast<size_t>(row) * len + i] =
        static_cast<signed char>(__float2int_rn(fminf(
            fmaxf(rintf(__fdiv_rn(to_f(src[i]), s)), -127.f), 127.f)));
  if (lane == 0) scale[row] = s;
}

template <typename T>
int quantize_weights(const void* w1, const void* w2, void* scratch, int C,
                     int Ch, cudaStream_t stream) {
  const QScratch S = qscratch_of(C, Ch);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  quantize_rows_kernel<T><<<(Ch + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(w1), Ch, C,
      reinterpret_cast<signed char*>(base + S.w1q),
      reinterpret_cast<float*>(base + S.sw1));
  quantize_rows_kernel<T><<<(C + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(w2), C, Ch,
      reinterpret_cast<signed char*>(base + S.w2q),
      reinterpret_cast<float*>(base + S.sw2));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NFW>
int launch_q(const void* x, const void* w1, const void* b1, const void* wdw,
             const void* bdw, const void* w2, const void* b2, void* y,
             void* scratch, int N, int H, int W, int C, int Ch, int residual,
             cudaStream_t stream) {
  int qerr = quantize_weights<T>(w1, w2, scratch, C, Ch, stream);
  if (qerr != 0) return qerr;
  const QScratch S = qscratch_of(C, Ch);
  const unsigned char* base = static_cast<const unsigned char*>(scratch);
  const int nbuf = pick_qnbuf<T, NFW>(C);
  const size_t smem = qsmem_of<T, NFW>(C);
  auto kernel = van_mlp_q_kernel<T, NFW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_y = (H + TILE - 1) / TILE;
  const int splits = sizeof(T) == 2 ? 1 : van_mlp_f32_splits(C);
  kernel<<<dim3(tiles_x * tiles_y, N, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(x),
      reinterpret_cast<const signed char*>(base + S.w1q),
      reinterpret_cast<const float*>(base + S.sw1), static_cast<const T*>(b1),
      static_cast<const T*>(wdw), static_cast<const T*>(bdw),
      reinterpret_cast<const signed char*>(base + S.w2q),
      reinterpret_cast<const float*>(base + S.sw2), static_cast<const T*>(b2),
      static_cast<T*>(y), H, W, C, Ch, tiles_x, nbuf, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which design rs_van_mlp_int8_fwd runs for this shape: 0 = none takes it, 1 =
// `van_mlp_q_kernel` (f32: any width, the f32 design; bf16: C in {32, 160},
// the first design), 2 = the wgmma design (bf16 at C in {64, 128, 256, 320,
// 512}). dtype: 0 = f32, 1 = bf16.
extern "C" int rs_van_mlp_int8_design(int C, int Ch, int dtype) {
  if (C <= 0 || Ch <= 0) return 0;
  if (dtype == 0) return 1;
  if (dtype != 1) return 0;
  if (rs::van_mlp_q_wgmma_takes(C, Ch)) return 2;
  return C == 32 || C == 160 ? 1 : 0;
}

// f32: the design's instantiation for C's output channels a thread
#define RS_VAN_MLP_Q_F32_SWITCH(C, CASE) \
  switch (van_mlp_f32_slots(C)) {        \
    CASE(1)                              \
    CASE(2)                              \
    CASE(4)                              \
    CASE(5)                              \
    CASE(8)                              \
    CASE(10)                             \
    CASE(16)                             \
  }

// Shared memory of one block of that design (0 where none takes the shape).
extern "C" size_t rs_van_mlp_int8_smem_bytes(int C, int Ch, int dtype) {
  switch (rs_van_mlp_int8_design(C, Ch, dtype)) {
    case 2: return rs::van_mlp_q_wgmma_smem_bytes(C);
    case 1:
      if (dtype == 1)
        return C == 32 ? qsmem_of<__nv_bfloat16, 1>(C)
                       : qsmem_of<__nv_bfloat16, 5>(C);
#define RS_CASE(j) \
  case j:          \
    return qsmem_of<float, j>(C);
      RS_VAN_MLP_Q_F32_SWITCH(C, RS_CASE)
#undef RS_CASE
  }
  return 0;
}

// Bytes of device scratch rs_van_mlp_int8_fwd wants: the quantized weights
// and their scales, in the layout of the design.
extern "C" size_t rs_van_mlp_int8_scratch_bytes(int C, int Ch, int dtype) {
  switch (rs_van_mlp_int8_design(C, Ch, dtype)) {
    case 2: return rs::van_mlp_q_wgmma_scratch_bytes(C, Ch);
    case 1: return qscratch_of(C, Ch).total;
  }
  return 0;
}

// The weight preparation of the wgmma design alone, as rs_van_mlp_int8_fwd
// runs it first: w1 [Ch, C] and w2 [C, Ch] (bf16) quantized per output
// channel and packed with b1, bdw, the taps and the scales into `scratch`,
// the kernel's shared-memory layout (ops/van_mlp.py:pack_int8_weights is its
// Python version). Refuses a shape the wgmma design does not take.
extern "C" int rs_van_mlp_int8_pack(const void* w1, const void* b1,
                                    const void* wdw, const void* bdw,
                                    const void* w2, void* scratch, int C,
                                    int Ch, int dtype, void* stream) {
  if (rs_van_mlp_int8_design(C, Ch, dtype) != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return rs::van_mlp_q_wgmma_pack(w1, b1, wdw, bdw, w2, scratch, C, Ch,
                                  static_cast<cudaStream_t>(stream));
}

// Launches the int8 form on `stream`: every tensor in `dtype`, layouts as
// rs_van_mlp_fwd; `scratch`: rs_van_mlp_int8_scratch_bytes() bytes, 16-byte
// aligned. Returns cudaGetLastError() (0 = success). residual != 0 writes
// x + mlp(x) (y must not alias x).
extern "C" int rs_van_mlp_int8_fwd(const void* x, const void* w1,
                                   const void* b1, const void* wdw,
                                   const void* bdw, const void* w2,
                                   const void* b2, void* y, void* scratch,
                                   int N, int H, int W, int C, int Ch,
                                   int dtype, int residual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int design = rs_van_mlp_int8_design(C, Ch, dtype);
  if (design == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (design == 2)
    return rs::van_mlp_q_wgmma_launch(x, w1, b1, wdw, bdw, w2, b2, y, scratch,
                                      N, H, W, C, Ch, residual, s);
  if (dtype == 0) {
#define RS_CASE(j)                                                          \
  case j:                                                                   \
    return launch_q<float, j>(x, w1, b1, wdw, bdw, w2, b2, y, scratch, N, H, \
                              W, C, Ch, residual, s);
    RS_VAN_MLP_Q_F32_SWITCH(C, RS_CASE)
#undef RS_CASE
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the two bf16 widths the wgmma design leaves: a 32-channel row is
  // narrower than a swizzled one, and 160 is no whole number of 64-channel
  // k blocks
  if (C == 32)
    return launch_q<__nv_bfloat16, 1>(x, w1, b1, wdw, bdw, w2, b2, y, scratch,
                                      N, H, W, C, Ch, residual, s);
  return launch_q<__nv_bfloat16, 5>(x, w1, b1, wdw, bdw, w2, b2, y, scratch, N,
                                    H, W, C, Ch, residual, s);
}
