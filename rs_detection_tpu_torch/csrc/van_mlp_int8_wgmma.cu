// Fused VAN MLP forward, the int8 serving form in bf16, the wgmma design for
// Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_van_mlp.py, `_mlp_kernel` with
// `quant=True` (`_qdot`, :101), at the widths van_mlp_q_wgmma_takes() names;
// van_mlp_int8.cu says what the function computes (the scale groups, the
// dequantizing arithmetic), holds its launcher and the kernel of every other
// shape. This source repeats that arithmetic to the bit: __fmul_rn /
// __fadd_rn / __fdiv_rn wherever a value feeds a quantizer or the output.
//
// What bounds it on the H100: the CUDA cores, as in the bf16 kernel
// (van_mlp_wgmma.cu): nine tap multiply-adds and an erf per hidden value, and
// here also a convert, a multiply and an add per output and 32-channel chunk,
// since every chunk's s32 product has a scale of its own. The s8 products are
// a quarter of a millisecond per forward at the tensor cores' peak. So the
// structure is the bf16 kernel's, with s8 operands:
//   * A block of two warpgroups owns an 8x8 output tile. The haloed 10x10 x
//     patch is read once from device memory into registers (16-byte loads),
//     its largest magnitude reduced over the block, and written as s8 into
//     64-byte swizzled rows of 64 channels.
//   * The hidden channels go in rounds of 64 (32 at C = 512, for registers):
//     fc1 is wgmma m64nKCk32 s8 x s8 -> s32 over the two 64-row halves of the
//     patch, the round after this one in flight while the depthwise 3x3 and
//     the GELU of this one run on the CUDA cores (a warp per output row, two
//     channels per lane). Its sums are dequantized in registers and written
//     once as bf16, zero outside the image.
//   * fc2's scale group is one 32-channel chunk, exactly one k32 step: a round
//     of 64 holds two chunks side by side in 64-byte rows, the second at +32
//     bytes. The GELU values stay in registers while the chunk's maxima go
//     through shared memory (one block barrier), then land as s8 in fc2's A
//     tile. Each (chunk, slab of output columns) is one wgmma with scale-d = 0
//     into one of two s32 slabs; while it runs the slab before it is added,
//     times the chunk's scale, to the f32 sums: in chunk order, as the plain
//     version adds them. Three block barriers per round of 64 channels, where
//     the first design has four or five per 32.
//   * The weights are quantized per output channel and repacked by a small
//     kernel (van_mlp_q_pack_kernel: amax, scale, s8, straight into the
//     swizzled bytes of the shared-memory buffers, zero past Ch) and arrive by
//     bulk copies that report to mbarriers, w1 two rounds ahead.
// The residual's x comes from device memory again at the end (the centre 64
// pixels, 4-byte loads): an s8 patch cannot give it back.

#include <type_traits>
#include <utility>

#include "pipeline.cuh"
#include "rs_common.cuh"
#include "van_mlp.cuh"
#include "wgmma.cuh"

namespace {

using namespace rs;
using bf16 = __nv_bfloat16;

constexpr int TILE = 8;               // output tile is TILE x TILE pixels
constexpr int HALO = TILE + 2;        // haloed tile side
constexpr int NPIX = HALO * HALO;     // haloed pixels
constexpr int XROWS = 104;            // haloed pixels, padded to 13 atoms
constexpr int THREADS = 256;          // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int XS_KB = XROWS * 64;     // bytes of one 64-channel block of x
constexpr int VS_SLOTS = 3;
constexpr int QCHUNK = 32;            // hidden channels of one fc2 scale

// Hidden channels per round: 64 (two scale chunks), and 32 at C = 512, where
// the f32 sums alone are 128 registers a thread.
__host__ __device__ constexpr int round_of(int C) { return C == 512 ? 32 : 64; }
// output columns of one fc2 product: a warpgroup's C / 2 columns in slabs
// (two s32 slabs are live beside the f32 sums: 32 columns where two blocks
// share an SM and a thread has 128 registers)
__host__ __device__ constexpr int slab_of(int C) {
  return C <= 128 ? 32 : C == 320 ? 80 : 64;
}
// bytes between pixels of the bf16 h1 buffer (see van_mlp_wgmma.cu)
__host__ __device__ constexpr int h1_ld(int kc) { return kc * 2 + 16; }
// bytes of b1 | bdw | 3x3 taps (bf16) | sw1 (f32) of a round
__host__ __device__ constexpr int vs_bytes(int kc) { return kc * 26; }
__host__ __device__ constexpr int w2_buffers(int C) { return C == 64 ? 2 : 1; }

struct Layout {
  int xs, w1s, w2s, gs, h1s, vs, red, bars, total;
};

__host__ __device__ constexpr Layout layout_of(int C) {
  Layout l{};
  const int kc = round_of(C);
  l.xs = 0;
  l.w1s = l.xs + (C / 64) * XS_KB;
  l.w2s = l.w1s + 2 * kc * C;
  l.gs = l.w2s + w2_buffers(C) * C * kc;
  l.h1s = l.gs + 64 * kc;  // fc2's A tile: 64 pixels x kc channels, s8
  l.vs = l.h1s + (NPIX * h1_ld(kc) + 127) / 128 * 128;
  l.red = l.vs + VS_SLOTS * vs_bytes(kc);
  l.bars = l.red + WARPS * 2 * 4;
  l.total = l.bars + 4 * 8;  // mbarriers: w1 buffers 0 and 1, w2 buffers
  return l;
}

// One round of the packed weights, as the kernel's shared memory wants it:
// w1 [C / 64][kc rows][64] s8 swizzled at 0, then b1 | bdw | taps | sw1 at
// `vs`, then w2 [C rows][kc] s8 swizzled at `w2`. sw2 [C] f32 follows the
// last round.
struct Packed {
  int vs, w2, total;
};
__host__ __device__ constexpr Packed packed_of(int C) {
  Packed p{};
  const int kc = round_of(C);
  p.vs = kc * C;
  p.w2 = p.vs + vs_bytes(kc);
  p.total = p.w2 + C * kc;
  return p;
}

// byte offset of the 16-byte vector `j` of row `r` in a tile whose rows are
// `row_bytes` (64 or 32) deep, in the swizzle of that depth
__host__ __device__ constexpr int swz_vec(int row_bytes, int r, int j) {
  return row_bytes == 64 ? ((j ^ (r >> 1)) & 3) << 4 : ((j ^ (r >> 2)) & 1) << 4;
}

// f(integral_constant<int, 0>), f(<1>), ...: a loop whose index is a
// compile-time constant in the body
template <int... T, typename F>
__device__ __forceinline__ void static_for(std::integer_sequence<int, T...>,
                                           F&& f) {
  (f(std::integral_constant<int, T>{}), ...);
}

// scale of a group with largest magnitude amax; its reciprocal quantizes
__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}
__device__ __forceinline__ int quant8(float v, float inv) {
  return __float2int_rn(
      fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f));
}
// a weight by its scale: a true divide, as ops/quant.py:qweight
__device__ __forceinline__ int quant8_div(float v, float scale) {
  return __float2int_rn(
      fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f));
}

template <int C>
__global__ void __launch_bounds__(THREADS, C <= 128 ? 2 : 1)
    van_mlp_q_wgmma_kernel(const bf16* __restrict__ x,
                           const unsigned char* __restrict__ wpack,
                           const bf16* __restrict__ b2, bf16* __restrict__ y,
                           int H, int W, int Ch, int tiles_x, int residual) {
  constexpr int KC = round_of(C);
  constexpr int NQ = KC / QCHUNK;       // scale chunks of a round
  constexpr int W1_KB = KC * 64;        // one 64-input-channel block of w1
  constexpr int H1_LD = h1_ld(KC), VS_BYTES = vs_bytes(KC);
  constexpr int W2_BYTES = C * KC;      // one w2 round
  constexpr int PAIRS = KC / 2;         // channel pairs of a round
  constexpr int XPT = TILE * PAIRS / 32;  // outputs of a row one lane takes
  constexpr int KB = C / 64;   // 64-channel blocks of the input width
  constexpr int N2 = C / 2;    // fc2 output columns of one warpgroup
  constexpr int NS = slab_of(C), NSLAB = N2 / NS;
  constexpr int STEPS = NQ * NSLAB;     // fc2 products of a round
  constexpr int VPP = C / 8;   // 16-byte vectors per pixel of x
  constexpr int NV = (XROWS * VPP + THREADS - 1) / THREADS;
  constexpr Layout L = layout_of(C);
  constexpr Packed P = packed_of(C);
  constexpr int W2B = w2_buffers(C);
  static_assert(N2 % NS == 0 && NS % 8 == 0, "slabs tile the columns");
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms want 1024-byte alignment
  const uint32_t sm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smp = smem_raw + (sm - smem_u32(smem_raw));
  // plain accesses at a shared address
  auto lds32 = [&](uint32_t a) {
    return *reinterpret_cast<const uint32_t*>(smp + (a - sm));
  };
  auto ldsf2 = [&](uint32_t a) {
    return *reinterpret_cast<const float2*>(smp + (a - sm));
  };
  auto sts32 = [&](uint32_t a, uint32_t v) {
    *reinterpret_cast<uint32_t*>(smp + (a - sm)) = v;
  };
  auto sts16 = [&](uint32_t a, unsigned short v) {
    *reinterpret_cast<unsigned short*>(smp + (a - sm)) = v;
  };
  const uint32_t xs = sm + L.xs, w1s = sm + L.w1s, w2s = sm + L.w2s,
                 gs = sm + L.gs, h1s = sm + L.h1s, vs = sm + L.vs,
                 bars = sm + L.bars;
  float* red = reinterpret_cast<float*>(smp + L.red);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;   // warpgroup
  const int wq = warp & 3;    // warp of the warpgroup
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TILE;
  const int tx0 = (blockIdx.x % tiles_x) * TILE;
  const bf16* xn = x + static_cast<size_t>(n) * H * W * C;
  const int nk = (Ch + KC - 1) / KC;
  const float* sw2 =
      reinterpret_cast<const float*>(wpack + static_cast<size_t>(nk) * P.total);

  // One thread starts a round's copies; they report to the mbarrier of their
  // buffer. w1 of round kc goes to buffer kc % 2 with its b1, bdw, taps and
  // sw1 to slot kc % VS_SLOTS, w2 to its buffer.
  auto copy_w1 = [&](int kc) {
    const unsigned char* src = wpack + static_cast<size_t>(kc) * P.total;
    const uint32_t bar = bars + (kc & 1) * 8;
    mbar_expect_tx(bar, P.w2);
    bulk_copy(w1s + (kc & 1) * (KC * C), src, P.vs, bar);
    bulk_copy(vs + (kc % VS_SLOTS) * VS_BYTES, src + P.vs, VS_BYTES, bar);
  };
  auto copy_w2 = [&](int kc) {
    const unsigned char* src = wpack + static_cast<size_t>(kc) * P.total;
    const uint32_t bar = bars + 16 + (kc % W2B) * 8;
    mbar_expect_tx(bar, W2_BYTES);
    bulk_copy(w2s + (kc % W2B) * W2_BYTES, src + P.w2, W2_BYTES, bar);
  };
  auto wait_w1 = [&](int kc) { mbar_wait(bars + (kc & 1) * 8, (kc >> 1) & 1); };
  auto wait_w2 = [&](int kc) {
    mbar_wait(bars + 16 + (kc % W2B) * 8, (kc / W2B) & 1);
  };

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    mbar_init(bars + 16, 1);
    mbar_init(bars + 24, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    copy_w1(0);
    if (nk > 1) copy_w1(1);
    if (W2B == 2) copy_w2(0);
  }

  // The x patch: once from device memory into registers, its largest
  // magnitude over the block, then s8 into the swizzled rows (zero outside
  // the image and in the padding rows).
  float sx;
  {
    uint4 xv[NV];
    float amax = 0.f;
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * THREADS;
      const int p = i / VPP;
      const int jv = i - p * VPP;
      const int gy = ty0 - 1 + p / HALO;
      const int gx = tx0 - 1 + p % HALO;
      const bool in = p < NPIX && gy >= 0 && gy < H && gx >= 0 && gx < W;
      xv[it] = in ? __ldg(reinterpret_cast<const uint4*>(
                        xn + (static_cast<size_t>(gy) * W + gx) * C + jv * 8))
                  : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t* e = reinterpret_cast<const uint32_t*>(&xv[it]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        amax = fmaxf(amax, fmaxf(fabsf(bf_lo(e[k])), fabsf(bf_hi(e[k]))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) amax = fmaxf(amax, red[i]);
    sx = scale_of(amax);
    const float xinv = __fdiv_rn(1.f, sx);
#pragma unroll
    for (int it = 0; it < NV; ++it) {
      const int i = tid + it * THREADS;
      if (i >= XROWS * VPP) continue;
      const int p = i / VPP;
      const int c0 = (i - p * VPP) * 8;
      const uint32_t* e = reinterpret_cast<const uint32_t*>(&xv[it]);
      uint32_t q[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        q[k] = (quant8(bf_lo(e[2 * k]), xinv) & 0xff) |
               (quant8(bf_hi(e[2 * k]), xinv) & 0xff) << 8 |
               (quant8(bf_lo(e[2 * k + 1]), xinv) & 0xff) << 16 |
               (quant8(bf_hi(e[2 * k + 1]), xinv) & 0xff) << 24;
      const uint32_t at = xs + (c0 >> 6) * XS_KB + p * 64 +
                          swz_vec(64, p, (c0 & 63) >> 4) + (c0 & 8);
      sts32(at, q[0]);
      sts32(at + 4, q[1]);
    }
  }

  int hacc[KC / 2];     // fc1: this warpgroup's 64 haloed pixels x KC channels
  float yacc[N2 / 2];   // fc2: 64 output pixels x N2 channels
  int part[2][NS / 2];  // fc2 of one (chunk, slab), two in turn
#pragma unroll
  for (int i = 0; i < N2 / 2; ++i) yacc[i] = 0.f;

  // fc1 of round buffer `buf`: hacc = xq[64 rows of this warpgroup] w1q^T
  auto start_fc1 = [&](int buf) {
    const uint64_t da = wgmma_desc64(xs + wg * 64 * 64);
    const uint64_t db = wgmma_desc64(w1s + buf * (KC * C));
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_ss_s8<KC>(hacc, da + ((kb * XS_KB + ks * 32) >> 4),
                        db + ((kb * W1_KB + ks * 32) >> 4), (kb | ks) != 0);
    wgmma_commit();
  };

  // this thread's two fragment rows as haloed pixels: 0 = outside the patch,
  // 1 = in the patch but outside the image (h1 is zero there), 2 = inside
  const int hp0 = wg * 64 + wq * 16 + (lane >> 2);
  int hstate[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = hp0 + 8 * r;
    const int gy = ty0 - 1 + p / HALO;
    const int gx = tx0 - 1 + p % HALO;
    hstate[r] = p >= NPIX ? 0
              : (gy >= 0 && gy < H && gx >= 0 && gx < W) ? 2 : 1;
  }
  // acc * (sx * sw1) + b1, round to bf16, zero the hidden tensor's SAME
  // padding, store once
  auto finish_h1 = [&](int slot) {
    const uint32_t vb1 = vs + slot * VS_BYTES + (lane & 3) * 4;
    const uint32_t vsw = vs + slot * VS_BYTES + KC * 22 + (lane & 3) * 8;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const uint32_t b = lds32(vb1 + j * 16);
      const float2 sw = ldsf2(vsw + j * 32);
      const float s0 = __fmul_rn(sx, sw.x), s1 = __fmul_rn(sx, sw.y);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (hstate[r] == 0) continue;
        const float v0 = __fadd_rn(
            __fmul_rn(static_cast<float>(hacc[4 * j + 2 * r]), s0), bf_lo(b));
        const float v1 = __fadd_rn(
            __fmul_rn(static_cast<float>(hacc[4 * j + 2 * r + 1]), s1),
            bf_hi(b));
        sts32(h1s + (hp0 + 8 * r) * H1_LD + j * 16 + (lane & 3) * 4,
              hstate[r] == 2 ? pack_bf16(v0, v1) : 0u);
      }
    }
  };

  fence_async_smem();  // the s8 patch is written for wgmma to read
  __syncthreads();
  wait_w1(0);
  start_fc1(0);
  wgmma_wait<0>();
  wgmma_pin(hacc);
  finish_h1(0);
  __syncthreads();

  // One round of the walk; `more` (a std::bool_constant) says whether another
  // follows. The last round is a second instantiation, not a run-time test
  // around the wgmma calls.
  auto round = [&](int k, auto more) {
    if (tid == 0) {
      if (W2B == 1) copy_w2(k);
      else if (k + 1 < nk) copy_w2(k + 1);
      if (k + 2 < nk) copy_w1(k + 2);
    }
    if constexpr (decltype(more)::value) {
      wait_w1(k + 1);
      start_fc1((k + 1) & 1);
    }

    // depthwise 3x3 + bdw + erf GELU of round k on the CUDA cores: this warp
    // takes output row `warp`, this lane channels 2 pair and 2 pair + 1 at
    // the XPT outputs from column qx0. The values stay in registers until
    // their chunk's scale is known.
    float sg[NQ];
    {
      const int pair = lane % PAIRS;
      const int qx0 = lane / PAIRS * XPT;
      const uint32_t vk = vs + (k % VS_SLOTS) * VS_BYTES;
      float tap[2][9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const uint32_t v = lds32(vk + 4 * KC + pair * 36 + i * 4);
        // the 18 values are [channel 2 pair][9], then [channel 2 pair + 1][9]
        tap[2 * i / 9][2 * i % 9] = bf_lo(v);
        tap[(2 * i + 1) / 9][(2 * i + 1) % 9] = bf_hi(v);
      }
      const uint32_t vb = lds32(vk + 2 * KC + pair * 4);
      float a[XPT][2];
#pragma unroll
      for (int q = 0; q < XPT; ++q) a[q][0] = a[q][1] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t row =
            h1s + ((warp + dy) * HALO + qx0) * H1_LD + pair * 4;
#pragma unroll
        for (int col = 0; col < XPT + 2; ++col) {
          const uint32_t v = lds32(row + col * H1_LD);
          const float lo = bf_lo(v), hi = bf_hi(v);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int q = col - dx;
            if (q >= 0 && q < XPT) {
              a[q][0] = fmaf(lo, tap[0][dy * 3 + dx], a[q][0]);
              a[q][1] = fmaf(hi, tap[1][dy * 3 + dx], a[q][1]);
            }
          }
        }
      }
      const float bd0 = bf_lo(vb), bd1 = bf_hi(vb);
      // zero at the pixels of a border tile outside the image: they take no
      // part in the chunk's scale
      float gmax = 0.f;
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const bool in = ty0 + warp < H && tx0 + qx0 + q < W;
        a[q][0] = in ? gelu_erf_as(a[q][0] + bd0) : 0.f;
        a[q][1] = in ? gelu_erf_as(a[q][1] + bd1) : 0.f;
        gmax = fmaxf(gmax, fmaxf(fabsf(a[q][0]), fabsf(a[q][1])));
      }
      // a chunk is 16 pairs: half a warp in a round of 64, all of it in 32
#pragma unroll
      for (int o = NQ == 2 ? 8 : 16; o > 0; o >>= 1)
        gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
      if ((lane & (NQ == 2 ? 15 : 31)) == 0)
        red[warp * NQ + (NQ == 2 ? lane >> 4 : 0)] = gmax;
      __syncthreads();
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        float m = red[c];
#pragma unroll
        for (int i = 1; i < WARPS; ++i) m = fmaxf(m, red[i * NQ + c]);
        sg[c] = scale_of(m);
      }
      const float ginv =
          __fdiv_rn(1.f, NQ == 2 && lane >= 16 ? sg[NQ - 1] : sg[0]);
      // s8 into fc2's A tile: row = pixel, KC bytes, swizzled by its depth
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int px = warp * TILE + qx0 + q;
        sts16(gs + px * KC + swz_vec(KC, px, pair >> 3) + (pair & 7) * 2,
              static_cast<unsigned short>(
                  (quant8(a[q][0], ginv) & 0xff) |
                  (quant8(a[q][1], ginv) & 0xff) << 8));
      }
    }
    fence_async_smem();  // g is written for wgmma to read
    __syncthreads();
    wait_w2(k);

    // fc2 of round k: per 32-channel chunk c and slab s of this warpgroup's
    // columns one product with scale-d = 0, then
    // yacc += sg[c] * float(part), chunk after chunk
    const uint32_t bs = w2s + (k % W2B) * W2_BYTES + wg * N2 * KC;
    auto issue = [&](auto tc) {
      constexpr int t = decltype(tc)::value;
      constexpr int c = t / NSLAB, s = t % NSLAB;
      const uint64_t da = (KC == 64 ? wgmma_desc64(gs) : wgmma_desc32(gs)) +
                          2 * c;
      const uint64_t db = (KC == 64 ? wgmma_desc64(bs + s * NS * KC)
                                    : wgmma_desc32(bs + s * NS * KC)) + 2 * c;
      wgmma_fence();
      wgmma_ss_s8<NS>(part[t & 1], da, db, 0);
      wgmma_commit();
    };
    issue(std::integral_constant<int, 0>{});
    if constexpr (decltype(more)::value) {
      wgmma_wait<1>();  // fc1 of round k + 1
      wgmma_pin(hacc);
      finish_h1((k + 1) % VS_SLOTS);
    }
    static_for(std::make_integer_sequence<int, STEPS>{}, [&](auto tc) {
      constexpr int t = decltype(tc)::value;
      if constexpr (t + 1 < STEPS) {
        issue(std::integral_constant<int, t + 1>{});
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      wgmma_pin(part[t & 1]);
      const float s = sg[t / NSLAB];
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) {
        float& acc = yacc[(t % NSLAB) * (NS / 2) + i];
        acc = __fadd_rn(acc, __fmul_rn(s, static_cast<float>(part[t & 1][i])));
      }
    });
    // every thread is done with gs, w2s and this round's h1, and the next
    // round's h1 is in place
    __syncthreads();
  };
  for (int k = 0; k + 1 < nk; ++k) round(k, std::true_type{});
  round(nk - 1, std::false_type{});

  // * sw2 + b2 (+ x, in f32), one cast, store the tile's in-image pixels
  bf16* yn = y + static_cast<size_t>(n) * H * W * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = wq * 16 + (lane >> 2) + 8 * r;
    const int gy = ty0 + q / TILE;
    const int gx = tx0 + q % TILE;
    if (gy >= H || gx >= W) continue;
    const size_t at = (static_cast<size_t>(gy) * W + gx) * C;
#pragma unroll
    for (int j = 0; j < N2 / 8; ++j) {
      const int c = wg * N2 + j * 8 + (lane & 3) * 2;
      const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(b2 + c));
      const float2 sw = __ldg(reinterpret_cast<const float2*>(sw2 + c));
      float v0 = __fadd_rn(__fmul_rn(yacc[4 * j + 2 * r], sw.x), bf_lo(b));
      float v1 = __fadd_rn(__fmul_rn(yacc[4 * j + 2 * r + 1], sw.y), bf_hi(b));
      if (residual) {
        const uint32_t xv =
            __ldg(reinterpret_cast<const uint32_t*>(xn + at + c));
        v0 = __fadd_rn(v0, bf_lo(xv));
        v1 = __fadd_rn(v1, bf_hi(xv));
      }
      *reinterpret_cast<uint32_t*>(yn + at + c) = pack_bf16(v0, v1);
    }
  }
}

// Quantizes w1 and w2 per output channel as ops/quant.py:qweight does (scale
// = amax / 127 by a true divide, 1 where the row is zero; q = clip(rint(w /
// scale)) by a true divide) and writes them, with b1, bdw, the taps and the
// scales, as the kernel's shared memory wants them: packed_of(C).total bytes
// per round (zero past Ch), sw2 after the last. One warp per weight row:
// warps [0, nk * KC) take the rows of w1, the next C those of w2.
template <int C>
__global__ void van_mlp_q_pack_kernel(const bf16* __restrict__ w1,
                                      const bf16* __restrict__ b1,
                                      const bf16* __restrict__ wdw,
                                      const bf16* __restrict__ bdw,
                                      const bf16* __restrict__ w2, int Ch,
                                      int nk, unsigned char* __restrict__ wpack) {
  constexpr Packed P = packed_of(C);
  constexpr int KC = round_of(C);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool first = row < nk * KC;   // a row of w1
  if (!first && row >= nk * KC + C) return;
  const int o = first ? row : row - nk * KC;
  const int len = first ? C : Ch;     // the row's length
  const bool live = !first || o < Ch;
  const bf16* src = (first ? w1 : w2) + static_cast<size_t>(o) * len;
  float amax = 0.f;
  if (live)
    for (int i = lane; i < len; i += 32)
      amax = fmaxf(amax, fabsf(__bfloat162float(src[i])));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
  const float scale = scale_of(amax);
  // four neighbouring values of the row per lane and turn: one 32-bit store
  // (a 16-byte vector of the swizzle never splits them)
  const int padded = first ? C : nk * KC;
  for (int i0 = lane * 4; i0 < padded; i0 += 128) {
    uint32_t q = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (live && i0 + e < len)
        q |= (quant8_div(__bfloat162float(src[i0 + e]), scale) & 0xff)
             << (8 * e);
    size_t at;
    if (first) {  // w1: [C / 64][KC rows][64]
      const int k = o / KC, r = o % KC;
      at = static_cast<size_t>(k) * P.total + (i0 >> 6) * (KC * 64) + r * 64 +
           swz_vec(64, r, (i0 & 63) >> 4) + (i0 & 15);
    } else {      // w2: [C rows][KC]
      const int k = i0 / KC, h = i0 % KC;
      at = static_cast<size_t>(k) * P.total + P.w2 + o * KC +
           swz_vec(KC, o, h >> 4) + (h & 15);
    }
    *reinterpret_cast<uint32_t*>(wpack + at) = q;
  }
  if (!first) {
    if (lane == 0)
      reinterpret_cast<float*>(wpack + static_cast<size_t>(nk) * P.total)[o] =
          scale;
    return;
  }
  // b1 | bdw | taps | sw1 of this hidden channel
  unsigned char* v = wpack + static_cast<size_t>(o / KC) * P.total + P.vs;
  const int r = o % KC;
  const bf16 zero = __float2bfloat16(0.f);
  if (lane < 9)
    reinterpret_cast<bf16*>(v + KC * 4)[r * 9 + lane] =
        live ? wdw[static_cast<size_t>(o) * 9 + lane] : zero;
  if (lane == 9) reinterpret_cast<bf16*>(v)[r] = live ? b1[o] : zero;
  if (lane == 10) reinterpret_cast<bf16*>(v + KC * 2)[r] = live ? bdw[o] : zero;
  if (lane == 11) reinterpret_cast<float*>(v + KC * 22)[r] = scale;
}

template <int C>
int pack(const void* w1, const void* b1, const void* wdw, const void* bdw,
         const void* w2, void* scratch, int Ch, cudaStream_t stream) {
  const int nk = (Ch + round_of(C) - 1) / round_of(C);
  const int rows = nk * round_of(C) + C;
  van_mlp_q_pack_kernel<C><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(wdw), static_cast<const bf16*>(bdw),
      static_cast<const bf16*>(w2), Ch, nk,
      static_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch(const void* x, const void* w1, const void* b1, const void* wdw,
           const void* bdw, const void* w2, const void* b2, void* y,
           void* scratch, int N, int H, int W, int Ch, int residual,
           cudaStream_t stream) {
  int err = pack<C>(w1, b1, wdw, bdw, w2, scratch, Ch, stream);
  if (err != 0) return err;
  const int smem = static_cast<int>(van_mlp_q_wgmma_smem_bytes(C));
  auto kernel = van_mlp_q_wgmma_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_y = (H + TILE - 1) / TILE;
  kernel<<<dim3(tiles_x * tiles_y, N), THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const unsigned char*>(scratch),
      static_cast<const bf16*>(b2), static_cast<bf16*>(y), H, W, Ch, tiles_x,
      residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace rs {

bool van_mlp_q_wgmma_takes(int C, int Ch) {
  return (C == 64 || C == 128 || C == 256 || C == 320 || C == 512) && Ch > 0;
}

size_t van_mlp_q_wgmma_smem_bytes(int C) {
  return static_cast<size_t>(layout_of(C).total) + 1024;  // alignment slack
}

size_t van_mlp_q_wgmma_scratch_bytes(int C, int Ch) {
  return static_cast<size_t>((Ch + round_of(C) - 1) / round_of(C)) *
             packed_of(C).total +
         static_cast<size_t>(C) * sizeof(float);
}

int van_mlp_q_wgmma_pack(const void* w1, const void* b1, const void* wdw,
                         const void* bdw, const void* w2, void* scratch, int C,
                         int Ch, cudaStream_t stream) {
#define RS_ARGS (w1, b1, wdw, bdw, w2, scratch, Ch, stream)
  switch (C) {
    case 64: return pack<64> RS_ARGS;
    case 128: return pack<128> RS_ARGS;
    case 256: return pack<256> RS_ARGS;
    case 320: return pack<320> RS_ARGS;
    case 512: return pack<512> RS_ARGS;
  }
#undef RS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

int van_mlp_q_wgmma_launch(const void* x, const void* w1, const void* b1,
                           const void* wdw, const void* bdw, const void* w2,
                           const void* b2, void* y, void* scratch, int N,
                           int H, int W, int C, int Ch, int residual,
                           cudaStream_t stream) {
#define RS_ARGS \
  (x, w1, b1, wdw, bdw, w2, b2, y, scratch, N, H, W, Ch, residual, stream)
  switch (C) {
    case 64: return launch<64> RS_ARGS;
    case 128: return launch<128> RS_ARGS;
    case 256: return launch<256> RS_ARGS;
    case 320: return launch<320> RS_ARGS;
    case 512: return launch<512> RS_ARGS;
  }
#undef RS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rs
