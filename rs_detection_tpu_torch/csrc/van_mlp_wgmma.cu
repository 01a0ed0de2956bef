// Fused VAN MLP forward, bf16, the wgmma design for Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_van_mlp.py, `_mlp_kernel` (reached
// through `van_mlp` and, with the residual flag, `van_mlp_residual`), at the
// widths van_mlp_wgmma_takes() names; van_mlp.cu holds what the function
// computes, its launcher and the kernel of every other shape.
//
// What bounds it on the H100: not bytes (the hidden tensor never leaves the
// SM) and not the tensor cores' peak (two products of 2.1 ms per VAN-b3
// forward), but the CUDA cores: every hidden value takes nine tap
// multiply-adds and an erf, some 6 ms per forward if nothing else ran, and
// with one block of eight warps on an SM (C >= 256) they run at about a
// third of their rate. So the design keeps the CUDA-core part lean and lets
// everything else run beside it:
//   * A block of two warpgroups owns an 8x8 output tile and walks the hidden
//     channels 64 at a time (32 at C = 512, where the x patch alone takes
//     104 KB of shared memory). Both products are wgmma with both operands in
//     swizzled shared memory (wgmma.cuh). fc1 of the haloed 10x10 patch is
//     two 64-row tiles, one per warpgroup (rows 100..127 are junk and
//     dropped); fc2 is one 64-row tile whose C output columns the warpgroups
//     split, its sums in registers for the whole tile. (Four warpgroups that
//     quarter the columns were tried: 128 registers a thread spill, and the
//     kernel ran 1.4 to 2 times slower.)
//   * wgmma is asynchronous, so the phases overlap inside each thread instead
//     of taking turns: fc1 of chunk k + 1 is started, then the depthwise 3x3
//     and GELU of chunk k run on the CUDA cores while the tensor cores work;
//     fc2 of chunk k is started, and fc1's result is finished (+ b1, rounded,
//     zero outside the image) while that runs. Two block barriers per chunk,
//     where the WMMA kernel has three per 32 channels. No wgmma is in flight
//     over the end of a chunk: ptxas serializes all of them when one is
//     (note C7514), and likewise when a run-time test stands around a wgmma
//     call, so the last chunk is an instantiation of its own.
//   * fc1's sums stay in registers until they are written once, as bf16
//     (they are rounded to bf16 anyway), into a pixel-major buffer whose
//     pixel stride (16 bytes more than the chunk) spreads a fragment's eight
//     rows over all banks.
//   * The depthwise conv gives a warp one output row and a lane two
//     neighbouring channels: a 32-bit load brings both, a row of ten haloed
//     pixels serves the eight outputs and three taps each, so an output costs
//     two shared loads instead of eighteen. The GELU is branch-free, so a
//     thread's sixteen interleave. Its output goes straight into fc2's
//     swizzled A tile.
//   * A small kernel first repacks the weights, per hidden chunk, into the
//     very bytes the shared-memory buffers hold (swizzle and all; zero past
//     Ch). One thread then brings a chunk in with three bulk copies
//     (cp.async.bulk) that report to an mbarrier: w1 with the chunk's b1, bdw
//     and taps two chunks ahead into a second buffer, w2 during the chunk's
//     depthwise phase (a chunk ahead at C = 64, where a second w2 buffer
//     fits). No thread spends its time on the copies; the weights are the
//     same for every block and stay in L2.
// The x patch (cp.async, swizzled on the way, zero outside the image) stays
// in shared memory for the residual add at the end.

#include <type_traits>

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
constexpr int XS_KB = XROWS * 128;    // bytes of one 64-channel block of x
constexpr int VS_SLOTS = 3;

// Hidden channels per chunk: 64, and 32 at C = 512, where the x patch alone
// takes 104 KB of shared memory. The chunk's other sizes follow from it.
__host__ __device__ constexpr int chunk_of(int C) { return C == 512 ? 32 : 64; }
// bytes of one 64-input-channel block of a w1 chunk
__host__ __device__ constexpr int w1_kb(int kc) { return kc * 128; }
// bytes between pixels of the h1 buffer: 16 more than the chunk spreads the
// eight rows of an accumulator fragment over all banks
__host__ __device__ constexpr int h1_ld(int kc) { return kc * 2 + 16; }
// bytes of b1 | bdw | 3x3 taps of a chunk, bf16
__host__ __device__ constexpr int vs_bytes(int kc) { return kc * 11 * 2; }

// two buffers for the w2 chunk where the tile is short of work to hide one
// copy behind (C = 64: a chunk's turn is about a microsecond)
__host__ __device__ constexpr int w2_buffers(int C) { return C == 64 ? 2 : 1; }

struct Layout {
  int xs, w1s, w2s, gs, h1s, vs, bars, total;
};

__host__ __device__ constexpr Layout layout_of(int C) {
  Layout l{};
  const int kc = chunk_of(C);
  l.xs = 0;
  l.w1s = l.xs + (C / 64) * XS_KB;
  l.w2s = l.w1s + 2 * (C / 64) * w1_kb(kc);
  l.gs = l.w2s + w2_buffers(C) * C * kc * 2;
  l.h1s = l.gs + 64 * kc * 2;  // fc2's A tile: 64 pixels x kc channels
  l.vs = l.h1s + (NPIX * h1_ld(kc) + 127) / 128 * 128;
  l.bars = l.vs + VS_SLOTS * vs_bytes(kc);
  l.total = l.bars + 4 * 8;  // mbarriers: w1 buffers 0 and 1, w2 buffers
  return l;
}

// One hidden chunk of the packed weights, as the kernel's shared memory wants
// it: w1 [C / 64][kc rows][64] swizzled at 0, then b1 | bdw | taps at `vs`,
// then w2 [C rows][kc] swizzled at `w2`.
struct Packed {
  int vs, w2, total;
};
__host__ __device__ constexpr Packed packed_of(int C) {
  Packed p{};
  const int kc = chunk_of(C);
  p.vs = (C / 64) * w1_kb(kc);
  p.w2 = p.vs + vs_bytes(kc);
  p.total = p.w2 + C * kc * 2;
  return p;
}

template <int C>
__global__ void __launch_bounds__(THREADS, C <= 128 ? 2 : 1)
    van_mlp_wgmma_kernel(const bf16* __restrict__ x,
                         const unsigned char* __restrict__ wpack,
                         const bf16* __restrict__ b2, bf16* __restrict__ y,
                         int H, int W, int Ch, int tiles_x, int residual) {
  constexpr int KC = chunk_of(C);
  constexpr int W1_KB = w1_kb(KC), H1_LD = h1_ld(KC), VS_BYTES = vs_bytes(KC);
  constexpr int W2_BYTES = C * KC * 2;  // one w2 chunk
  constexpr int PAIRS = KC / 2;         // channel pairs of a chunk
  constexpr int XPT = TILE * PAIRS / 32;  // outputs of a row one lane takes
  constexpr int KB = C / 64;   // 64-channel blocks of the input width
  constexpr int N2 = C / 2;    // fc2 output columns of one warpgroup
  constexpr int VPP = C / 8;   // 16-byte vectors per pixel (or w1 row)
  constexpr Layout L = layout_of(C);
  constexpr Packed P = packed_of(C);
  constexpr int W2B = w2_buffers(C);
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms want 1024-byte alignment
  const uint32_t sm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smp = smem_raw + (sm - smem_u32(smem_raw));
  // plain 32-bit accesses at a shared address
  auto lds32 = [&](uint32_t a) {
    return *reinterpret_cast<const uint32_t*>(smp + (a - sm));
  };
  auto sts32 = [&](uint32_t a, uint32_t v) {
    *reinterpret_cast<uint32_t*>(smp + (a - sm)) = v;
  };
  const uint32_t xs = sm + L.xs, w1s = sm + L.w1s, w2s = sm + L.w2s,
                 gs = sm + L.gs, h1s = sm + L.h1s, vs = sm + L.vs,
                 bars = sm + L.bars;

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

  auto load_x = [&]() {
    for (int i = tid; i < XROWS * VPP; i += THREADS) {
      const int p = i / VPP;
      const int jv = i - p * VPP;
      const int gy = ty0 - 1 + p / HALO;
      const int gx = tx0 - 1 + p % HALO;
      const bool in = p < NPIX && gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(xs + (jv >> 3) * XS_KB + p * 128 + ((((jv & 7) ^ p) & 7) << 4),
           in ? xn + (static_cast<size_t>(gy) * W + gx) * C + jv * 8 : nullptr,
           x);
    }
  };
  // One thread starts the chunk's copies; they report to the mbarrier of
  // their buffer. w1 of chunk kc goes to buffer kc % 2 with its b1, bdw and
  // taps to slot kc % VS_SLOTS, w2 to its one buffer.
  const unsigned char* wchunk = wpack;
  auto copy_w1 = [&](int kc) {
    const unsigned char* src = wchunk + static_cast<size_t>(kc) * P.total;
    const uint32_t bar = bars + (kc & 1) * 8;
    mbar_expect_tx(bar, P.w2);
    bulk_copy(w1s + (kc & 1) * (KB * W1_KB), src, P.vs, bar);
    bulk_copy(vs + (kc % VS_SLOTS) * VS_BYTES, src + P.vs, VS_BYTES, bar);
  };
  auto copy_w2 = [&](int kc) {
    const unsigned char* src = wchunk + static_cast<size_t>(kc) * P.total;
    const uint32_t bar = bars + 16 + (kc % W2B) * 8;
    mbar_expect_tx(bar, W2_BYTES);
    bulk_copy(w2s + (kc % W2B) * W2_BYTES, src + P.w2, W2_BYTES, bar);
  };
  // chunk kc is the (kc / 2)-th use of its w1 buffer, the kc-th of w2's
  auto wait_w1 = [&](int kc) { mbar_wait(bars + (kc & 1) * 8, (kc >> 1) & 1); };
  auto wait_w2 = [&](int kc) {
    mbar_wait(bars + 16 + (kc % W2B) * 8, (kc / W2B) & 1);
  };

  float hacc[KC / 2];   // fc1: this warpgroup's 64 haloed pixels x KC channels
  float yacc[N2 / 2];   // fc2: 64 output pixels x N2 channels

  // fc1 of chunk buffer `buf`: hacc = x[64 rows of this warpgroup] w1^T
  auto start_fc1 = [&](int buf) {
    const uint64_t da = wgmma_desc(xs + wg * 64 * 128);
    const uint64_t db = wgmma_desc(w1s + buf * (KB * W1_KB));
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss<KC>(hacc, da + ((kb * XS_KB + ks * 32) >> 4),
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
  // + b1, round to bf16, zero the hidden tensor's SAME padding, store once
  auto finish_h1 = [&](int slot) {
    const uint32_t vb1 = vs + slot * VS_BYTES + (lane & 3) * 4;
    uint32_t bias[KC / 8];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) bias[j] = lds32(vb1 + j * 16);
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const uint32_t b = bias[j];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (hstate[r] == 0) continue;
        const uint32_t v =
            hstate[r] == 2 ? pack_bf16(hacc[4 * j + 2 * r] + bf_lo(b),
                                       hacc[4 * j + 2 * r + 1] + bf_hi(b))
                           : 0u;
        sts32(h1s + (hp0 + 8 * r) * H1_LD + j * 16 + (lane & 3) * 4, v);
      }
    }
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
  load_x();
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  wait_w1(0);
  start_fc1(0);
  wgmma_wait<0>();
  wgmma_pin(hacc);
  finish_h1(0);
  __syncthreads();

  // One chunk of the walk; `more` (a std::bool_constant) says whether another
  // follows. The last chunk is a second instantiation, not a run-time test
  // around the wgmma calls.
  auto chunk = [&](int k, auto more) {
    // in flight during this chunk: w2 of chunk k (needed by fc2 below; of
    // chunk k + 1 where w2 has two buffers) and w1 of chunk k + 2 (its
    // buffer held chunk k, whose fc1 is done)
    if (tid == 0) {
      if (W2B == 1) copy_w2(k);
      else if (k + 1 < nk) copy_w2(k + 1);
      if (k + 2 < nk) copy_w1(k + 2);
    }
    if constexpr (decltype(more)::value) {
      wait_w1(k + 1);
      start_fc1((k + 1) & 1);
    }

    // depthwise 3x3 + bdw + erf GELU of chunk k on the CUDA cores: this warp
    // takes output row `warp`, this lane channels 2 pair and 2 pair + 1 at
    // the XPT outputs from column qx0
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
      // g into fc2's A tile: row = pixel, KC * 2 bytes, 16-byte vectors
      // swizzled by the row (128-byte mode) or by half the row (64-byte mode)
#pragma unroll
      for (int q = 0; q < XPT; ++q) {
        const int px = warp * TILE + qx0 + q;
        const int sw = KC == 64 ? px : px >> 1;
        sts32(gs + px * (KC * 2) +
                  ((((pair >> 2) ^ sw) & (KC / 8 - 1)) << 4) + (pair & 3) * 4,
              pack_bf16(gelu_erf_as(a[q][0] + bd0),
                        gelu_erf_as(a[q][1] + bd1)));
      }
    }
    fence_async_smem();  // g is written for wgmma to read
    __syncthreads();
    wait_w2(k);

    // fc2 of chunk k: yacc += g w2^T for this warpgroup's N2 columns
    {
      const uint32_t bs = w2s + (k % W2B) * W2_BYTES + wg * N2 * (KC * 2);
      const uint64_t da = KC == 64 ? wgmma_desc(gs) : wgmma_desc64(gs);
      const uint64_t db = KC == 64 ? wgmma_desc(bs) : wgmma_desc64(bs);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        wgmma_ss<N2>(yacc, da + 2 * ks, db + 2 * ks, (k | ks) != 0);
      wgmma_commit();
    }
    if constexpr (decltype(more)::value) {
      wgmma_wait<1>();  // fc1 of chunk k + 1
      wgmma_pin(hacc);
      finish_h1((k + 1) % VS_SLOTS);
    }
    wgmma_wait<0>();
    wgmma_pin(yacc);
    // every thread is done with gs, w2s and this chunk's h1, and the next
    // chunk's h1 is in place
    __syncthreads();
  };
  for (int k = 0; k + 1 < nk; ++k) chunk(k, std::true_type{});
  chunk(nk - 1, std::false_type{});

  // + b2 (+ x's centre pixel from the patch, in f32), one cast, store the
  // tile's in-image pixels
  bf16* yn = y + static_cast<size_t>(n) * H * W * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = wq * 16 + (lane >> 2) + 8 * r;
    const int gy = ty0 + q / TILE;
    const int gx = tx0 + q % TILE;
    if (gy >= H || gx >= W) continue;
    const int p = (q / TILE + 1) * HALO + q % TILE + 1;
    bf16* yrow = yn + (static_cast<size_t>(gy) * W + gx) * C;
#pragma unroll
    for (int j = 0; j < N2 / 8; ++j) {
      const int c = wg * N2 + j * 8 + (lane & 3) * 2;
      const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(b2 + c));
      float v0 = yacc[4 * j + 2 * r] + bf_lo(b);
      float v1 = yacc[4 * j + 2 * r + 1] + bf_hi(b);
      if (residual) {
        const uint32_t xv = lds32(xs + (c >> 6) * XS_KB + swz128(p, c & 63));
        v0 += bf_lo(xv);
        v1 += bf_hi(xv);
      }
      *reinterpret_cast<uint32_t*>(yrow + c) = pack_bf16(v0, v1);
    }
  }
}

// Writes the weights as the kernel's shared memory wants them, one block of
// packed_of(C).total bytes per hidden chunk (zero past Ch), so that a chunk
// arrives by three bulk copies. One thread per 16-byte vector.
template <int C>
__global__ void van_mlp_pack_kernel(const bf16* __restrict__ w1,
                                    const bf16* __restrict__ b1,
                                    const bf16* __restrict__ wdw,
                                    const bf16* __restrict__ bdw,
                                    const bf16* __restrict__ w2, int Ch,
                                    uint4* __restrict__ wpack) {
  constexpr Packed P = packed_of(C);
  constexpr int KC = chunk_of(C);
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= P.total / 16) return;
  const int k0 = blockIdx.y * KC;
  const bf16* src = nullptr;
  if (v < P.vs / 16) {  // w1: [C / 64][KC rows][8 vectors], swizzled
    const int kb = v / (KC * 8), r = (v >> 3) % KC, j = (v ^ r) & 7;
    if (k0 + r < Ch)
      src = w1 + static_cast<size_t>(k0 + r) * C + kb * 64 + j * 8;
  } else if (v < P.w2 / 16) {  // b1 (KC / 8 vectors) | bdw | taps (9 KC / 8)
    const int i = v - P.vs / 16;
    if (i < KC / 8) {
      if (k0 + i * 8 < Ch) src = b1 + k0 + i * 8;
    } else if (i < KC / 4) {
      if (k0 + (i - KC / 8) * 8 < Ch) src = bdw + k0 + (i - KC / 8) * 8;
    } else if (k0 * 9 + (i - KC / 4) * 8 < Ch * 9) {
      src = wdw + static_cast<size_t>(k0) * 9 + (i - KC / 4) * 8;
    }
  } else {  // w2: [C rows][KC / 8 vectors], swizzled as the g tile is
    const int i = v - P.w2 / 16;
    const int r = i / (KC / 8);
    const int j = (i ^ (KC == 64 ? r : r >> 1)) & (KC / 8 - 1);
    if (k0 + j * 8 < Ch) src = w2 + static_cast<size_t>(r) * Ch + k0 + j * 8;
  }
  wpack[static_cast<size_t>(blockIdx.y) * (P.total / 16) + v] =
      src ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
}

template <int C>
int launch(const void* x, const void* w1, const void* b1, const void* wdw,
           const void* bdw, const void* w2, const void* b2, void* y,
           void* scratch, int N, int H, int W, int Ch, int residual,
           cudaStream_t stream) {
  const int nk = (Ch + chunk_of(C) - 1) / chunk_of(C);
  const int vecs = packed_of(C).total / 16;
  van_mlp_pack_kernel<C><<<dim3((vecs + 255) / 256, nk), 256, 0, stream>>>(
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(wdw), static_cast<const bf16*>(bdw),
      static_cast<const bf16*>(w2), Ch, static_cast<uint4*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = static_cast<int>(van_mlp_wgmma_smem_bytes(C));
  auto kernel = van_mlp_wgmma_kernel<C>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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

bool van_mlp_wgmma_takes(int C, int Ch) {
  return (C == 64 || C == 128 || C == 256 || C == 320 || C == 512) && Ch > 0 &&
         Ch % 8 == 0;
}

size_t van_mlp_wgmma_smem_bytes(int C) {
  return static_cast<size_t>(layout_of(C).total) + 1024;  // alignment slack
}

size_t van_mlp_wgmma_scratch_bytes(int C, int Ch) {
  return static_cast<size_t>((Ch + chunk_of(C) - 1) / chunk_of(C)) *
         packed_of(C).total;
}

int van_mlp_wgmma_launch(const void* x, const void* w1, const void* b1,
                         const void* wdw, const void* bdw, const void* w2,
                         const void* b2, void* y, void* scratch, int N, int H,
                         int W, int C, int Ch, int residual,
                         cudaStream_t stream) {
  switch (C) {
#define RS_CASE(c)                                                          \
  case c:                                                                   \
    return launch<c>(x, w1, b1, wdw, bdw, w2, b2, y, scratch, N, H, W, Ch, \
                     residual, stream);
    RS_CASE(64)
    RS_CASE(128)
    RS_CASE(256)
    RS_CASE(320)
    RS_CASE(512)
#undef RS_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rs
