// Fused VAN attention half-block (K4), the two channel-mixing stages `proj1`
// and `tail` in bf16, the wgmma design for Hopper (sm_90a).
//
// Replaces: rs_detection_tpu/ops/pallas_van_attn.py, `_attn_kernel` (reached
// through `van_attn`), at the widths van_attn_wgmma_takes() names. van_attn.cu
// says what the stages compute and where they round, holds the launcher and
// the kernels of every other shape (f32, other widths).
//
// What bounds them on the H100: bytes. A forward of VAN-b3 at batch 8, 1024^2
// moves 0.96 GB per pass over the activations; `proj1` is two passes (x in, g
// out), `tail` four (x, g, d7 in, out out), 1.7 ms at 3.35 TB/s, against 0.7
// ms for the three C x C products at the tensor cores' peak. So the design
// moves every activation byte once, in full lines, and keeps the tensor cores
// and the weight traffic out of the way:
//   * A block of two warpgroups owns 128 consecutive pixels, 64 a warpgroup
//     (one warpgroup and 64 pixels for `tail` at C = 512, where two activation
//     tiles of 128 pixels do not fit). The pixel tile is wgmma's A operand in
//     128-byte swizzled shared memory: `proj1` loads x in 16-byte vectors and
//     applies the bn1 affine on the way, `tail` brings d7 in by cp.async.
//   * The weights are repacked by a small kernel into slabs of 64 output
//     channels (32 where the ring would not fit), each the very bytes of a
//     swizzled B tile, and stream through a ring of two or three buffers by
//     cp.async.bulk + mbarrier: one thread starts the copy of slab t + R when
//     slab t's product is done. A block reads the C x C weights once per 128
//     pixels from L2, where the first design read them once per 64.
//   * Each slab is KB x 4 wgmma m64nNSk16 into one of two accumulator sets;
//     while slab t runs, the epilogue of slab t - 1 works on the other set.
//     One block barrier per slab (it also frees the slab's ring buffer).
//   * `proj1`: + bp1, round, GELU, into one of two staging tiles, then
//     16-byte stores of whole 128-byte (64-byte) row segments of g.
//   * `tail` holds two activation tiles and works in place in both: the
//     prologue brings d7 into the first and g into the second (the first
//     product starts when d7 is in); the first product's epilogue turns g, element by element, into round(g * (c1 +
//     bc1)), which is the second product's A tile; between the products x
//     takes the place of d7 (cp.async, in flight under the second product's
//     first slab); the second product's epilogue turns x into x + ls1 * (p2 +
//     bp2 + h), and the tile goes to `out` at the end. Every activation byte
//     moves once, in 16-byte vectors, and nothing is staged.

#include "pipeline.cuh"
#include "rs_common.cuh"
#include "van_attn.cuh"
#include "wgmma.cuh"

namespace {

using namespace rs;
using bf16 = __nv_bfloat16;

// Per stage and width: the output channels of one weight slab (wide slabs
// read the A tile from shared memory less often: 64 where the ring fits),
// the warpgroups (64 pixels each) of a block, the buffers of the weight ring.
__host__ __device__ constexpr int proj1_slab(int C) { return C <= 320 ? 64 : 32; }
__host__ __device__ constexpr int proj1_wgs(int) { return 2; }
__host__ __device__ constexpr int proj1_ring(int C) {
  return C == 64 ? 1 : C == 256 ? 3 : 2;  // C = 64 is one slab
}
__host__ __device__ constexpr int tail_slab(int C) { return C <= 256 ? 64 : 32; }
__host__ __device__ constexpr int tail_wgs(int C) { return C == 512 ? 1 : 2; }
__host__ __device__ constexpr int tail_ring(int C) { return C <= 128 ? 2 : 3; }
// bytes between the rows of a staging tile: 16 more than the slab spreads a
// fragment's eight rows over all banks
__host__ __device__ constexpr int stage_ld(int ns) { return ns * 2 + 16; }

struct Layout {
  int a, a2, ring, stage, bars, total;
};
// `tiles` activation tiles of `wgs` x 64 pixels, `nbuf` ring buffers of `ns`
// output channels, `stages` staging tiles per warpgroup
__host__ __device__ constexpr Layout layout_of(int C, int ns, int tiles,
                                               int wgs, int nbuf, int stages) {
  Layout l{};
  l.a = 0;
  l.a2 = wgs * 64 * C * 2;
  l.ring = tiles * wgs * 64 * C * 2;
  l.stage = l.ring + nbuf * ns * C * 2;
  l.bars = l.stage + stages * wgs * 64 * stage_ld(ns);
  l.total = l.bars + nbuf * 8;
  return l;
}
// proj1: the h tile and two staging tiles a warpgroup, written in turn (one
// where there is one slab)
__host__ __device__ constexpr int proj1_stages(int C) {
  return C / proj1_slab(C) > 1 ? 2 : 1;
}
__host__ __device__ constexpr Layout proj1_layout(int C) {
  return layout_of(C, proj1_slab(C), 1, proj1_wgs(C), proj1_ring(C),
                   proj1_stages(C));
}
// tail: two activation tiles; its results go back into them
__host__ __device__ constexpr Layout tail_layout(int C) {
  return layout_of(C, tail_slab(C), 2, tail_wgs(C), tail_ring(C), 0);
}

// byte offset of the 16-byte vector that holds channels [c0, c0 + 8) of row p
// in a swizzled activation tile of M rows: [C / 64][M][128 bytes]
__device__ __forceinline__ int tile_vec(int M, int p, int c0) {
  return (c0 >> 6) * (M * 128) + p * 128 + (((((c0 & 63) >> 3) ^ p) & 7) << 4);
}

// The weight ring of one block: slab t of `wpack` (NS output channels, the
// bytes of a swizzled B tile) goes to buffer t % R and reports to that
// buffer's mbarrier.
template <int C, int NS, int STEPS, int R>
struct SlabRing {
  static constexpr int SLAB_BYTES = NS * C * 2;
  uint32_t ring, bars;
  const unsigned char* wpack;

  __device__ __forceinline__ void copy(int t) const {
    const uint32_t bar = bars + (t % R) * 8;
    mbar_expect_tx(bar, SLAB_BYTES);
    bulk_copy(ring + (t % R) * SLAB_BYTES,
              wpack + static_cast<size_t>(t) * SLAB_BYTES, SLAB_BYTES, bar);
  }
  // one thread: the barriers and the first R slabs
  __device__ __forceinline__ void start() const {
    for (int b = 0; b < R; ++b) mbar_init(bars + b * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < R && t < STEPS; ++t) copy(t);
  }
  __device__ __forceinline__ uint32_t buffer(int t) const {
    return ring + (t % R) * SLAB_BYTES;
  }
  __device__ __forceinline__ void wait(int t) const {
    mbar_wait(bars + (t % R) * 8, (t / R) & 1);
  }
  // The block barrier of slab e's epilogue: after it every warpgroup is done
  // with the slab's buffer, which takes slab e + R. Every thread calls it
  // once per slab.
  __device__ __forceinline__ void sync_refill(int e) const {
    __syncthreads();
    if (threadIdx.x == 0 && e + R < STEPS) copy(e + R);
  }
};

// The pixel-tile products of both stages, step T of NMAT * NSLAB: NMAT
// chained C x C products over the block's tile. Product m multiplies the tile
// at `a` (m = 0) or `a2` (m = 1) by the slabs [m * NSLAB, (m + 1) * NSLAB) of
// the ring, and epi.template run<m>(s, acc, ring, e) gets the f32 sums of
// slab s = e % NSLAB (this thread's fragment: rows wq * 16 + lane / 4 and + 8
// of its warpgroup, columns s * NS + 8 j + 2 (lane % 4) + {0, 1} in
// acc[4 j + {0, 1}] and acc[4 j + {2, 3}]) and calls ring.sync_refill(e)
// once. While slab T runs on the tensor cores, the epilogue of slab T - 1
// works on the other accumulator set. What run<0> wrote for wgmma to read is
// fenced and visible before product 1 starts, and epi.between() runs there,
// when every read of product 0's A tile is done.
template <int C, int NS, int NWG, int NMAT, int R, int T, typename Epi>
struct SlabSteps {
  static constexpr int NSLAB = C / NS, STEPS = NMAT * NSLAB;
  static constexpr int KB = C / 64, M = NWG * 64;
  using Ring = SlabRing<C, NS, STEPS, R>;

  template <int E>
  static __device__ __forceinline__ void finish(const Ring& ring,
                                                float (&acc)[2][NS / 2],
                                                Epi& epi) {
    wgmma_pin(acc[E & 1]);
    epi.template run<E / NSLAB>(E % NSLAB, acc[E & 1], ring, E);
  }

  static __device__ __forceinline__ void run(const Ring& ring, uint32_t a,
                                             uint32_t a2,
                                             float (&acc)[2][NS / 2],
                                             Epi& epi) {
    constexpr bool boundary = T > 0 && T % NSLAB == 0;
    if constexpr (boundary) {
      // the product before this one wrote this one's A tile
      wgmma_wait<0>();
      finish<T - 1>(ring, acc, epi);
      fence_async_smem();
      __syncthreads();
      epi.between();
    }
    ring.wait(T);
    {
      const int wg = threadIdx.x >> 7;
      const uint64_t da = wgmma_desc((T / NSLAB == 0 ? a : a2) + wg * 64 * 128);
      const uint64_t db = wgmma_desc(ring.buffer(T));
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < KB; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss<NS>(acc[T & 1], da + ((kb * M * 128 + ks * 32) >> 4),
                       db + ((kb * NS * 128 + ks * 32) >> 4), (kb | ks) != 0);
      wgmma_commit();
    }
    if constexpr (T > 0 && !boundary) {
      wgmma_wait<1>();
      finish<T - 1>(ring, acc, epi);
    }
    if constexpr (T + 1 < STEPS) {
      SlabSteps<C, NS, NWG, NMAT, R, T + 1, Epi>::run(ring, a, a2, acc, epi);
    } else {
      wgmma_wait<0>();
      finish<T>(ring, acc, epi);
    }
  }
};

// proj1's epilogue: + bp1, round, GELU into one of the warpgroup's two
// staging tiles, the slab's block barrier, then the tile to g: 64 rows of NS
// bf16 in 16-byte vectors, a row's vectors on neighbouring threads. The next
// slab writes the other tile, and the barrier after that frees this one.
template <int C>
struct Proj1Epi {
  static constexpr int NS = proj1_slab(C), NSLAB = C / NS, VPR = NS / 8;
  const bf16* bp1;
  bf16* g;
  unsigned char* stage;  // this warpgroup's two staging tiles
  long long p0, P;       // this warpgroup's first pixel, the pixel count

  template <int MI, typename Ring>
  __device__ __forceinline__ void run(int s, float (&acc)[NS / 2],
                                      const Ring& ring, int e) {
    const int lane = threadIdx.x & 31, tq = threadIdx.x & 127;
    const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    unsigned char* tile = stage + (e % proj1_stages(C)) * 64 * stage_ld(NS);
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      const uint32_t b =
          __ldg(reinterpret_cast<const uint32_t*>(bp1 + s * NS + c));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t pre = pack_bf16(acc[4 * j + 2 * r] + bf_lo(b),
                                       acc[4 * j + 2 * r + 1] + bf_hi(b));
        *reinterpret_cast<uint32_t*>(tile + (row + 8 * r) * stage_ld(NS) +
                                     c * 2) =
            pack_bf16(gelu_erf_as(bf_lo(pre)), gelu_erf_as(bf_hi(pre)));
      }
    }
    ring.sync_refill(e);
#pragma unroll
    for (int it = 0; it < 64 * VPR / 128; ++it) {
      const int i = tq + it * 128;
      const int r = i / VPR, v = i % VPR;
      if (p0 + r < P)
        *reinterpret_cast<uint4*>(g + (p0 + r) * C + s * NS + v * 8) =
            *reinterpret_cast<const uint4*>(tile + r * stage_ld(NS) + v * 16);
    }
  }
  __device__ __forceinline__ void between() {}
};

// proj1: g = gelu_erf(round(round(a1 * x + b1) @ wp1^T + bp1)) for the
// block's pixels of the P = N * H * W.
template <int C>
__global__ void __launch_bounds__(128 * proj1_wgs(C))
    attn_proj1_wgmma_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ a1,
                            const float* __restrict__ b1,
                            const unsigned char* __restrict__ wpack,
                            const bf16* __restrict__ bp1, bf16* __restrict__ g,
                            long long P) {
  constexpr int NWG = proj1_wgs(C), M = NWG * 64, NS = proj1_slab(C);
  constexpr int VPP = C / 8;
  constexpr int R = proj1_ring(C);
  constexpr Layout L = proj1_layout(C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smp = smem_raw + (sm - smem_u32(smem_raw));
  const int tid = threadIdx.x, wg = tid >> 7;
  const long long p0 = static_cast<long long>(blockIdx.x) * M;
  const SlabRing<C, NS, C / NS, R> ring{sm + L.ring, sm + L.bars, wpack};
  if (tid == 0) ring.start();
  // x into the swizzled A tile (cp.async: every vector of the tile in flight
  // at once; zero past P), then h = round(a1 * x + b1) in place, each thread
  // on the vectors it copied
  for (int i = tid; i < M * VPP; i += 128 * NWG) {
    const int p = i / VPP, c0 = (i - p * VPP) * 8;
    cp_async16(sm + L.a + tile_vec(M, p, c0),
               p0 + p < P ? x + (p0 + p) * C + c0 : nullptr, x);
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int i = tid; i < M * VPP; i += 128 * NWG) {
    const int p = i / VPP, c0 = (i - p * VPP) * 8;
    if (p0 + p >= P) continue;
    uint4* at = reinterpret_cast<uint4*>(smp + L.a + tile_vec(M, p, c0));
    const uint4 v = *at;
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(a1 + c0)),
                 s1 = __ldg(reinterpret_cast<const float4*>(a1 + c0 + 4)),
                 t0 = __ldg(reinterpret_cast<const float4*>(b1 + c0)),
                 t1 = __ldg(reinterpret_cast<const float4*>(b1 + c0 + 4));
    uint4 out;
    out.x = pack_bf16(s0.x * bf_lo(v.x) + t0.x, s0.y * bf_hi(v.x) + t0.y);
    out.y = pack_bf16(s0.z * bf_lo(v.y) + t0.z, s0.w * bf_hi(v.y) + t0.w);
    out.z = pack_bf16(s1.x * bf_lo(v.z) + t1.x, s1.y * bf_hi(v.z) + t1.y);
    out.w = pack_bf16(s1.z * bf_lo(v.w) + t1.z, s1.w * bf_hi(v.w) + t1.w);
    *at = out;
  }
  fence_async_smem();
  __syncthreads();

  Proj1Epi<C> epi{bp1, g,
                  smp + L.stage + wg * proj1_stages(C) * 64 * stage_ld(NS),
                  p0 + wg * 64, P};
  float acc[2][NS / 2];
  SlabSteps<C, NS, NWG, 1, R, 0, Proj1Epi<C>>::run(ring, sm + L.a, 0u, acc,
                                                   epi);
}

// tail's epilogues. Both work in place in the block's two activation tiles, a
// thread on the elements of its own fragment, so nothing needs staging.
// Product 0: round(g * (c1 + bc1)), g from the second tile (the prologue put
// it there) and the product back into its place, where product 1 reads it.
// Between the products d7's tile is dead, and x takes it (cp.async). Product
// 1: x + ls1 * (p2 + bp2 + h), h = round(a1 * x + b1), x from that tile and
// the result back into its place; the kernel stores the tile when all slabs
// are done.
template <int C>
struct TailEpi {
  static constexpr int NS = tail_slab(C), NSLAB = C / NS;
  static constexpr int NWG = tail_wgs(C), M = NWG * 64, VPP = C / 8;
  const bf16 *x, *bc1, *bp2, *ls1;
  const float *a1, *b1;
  uint32_t a_sm;         // shared address of the first tile
  unsigned char* a;      // the block's first tile: d7, then x, then out
  unsigned char* gated;  // the block's second tile: g, then the product
  long long p0, P;       // the block's first pixel, the pixel count

  // rows [p0, p0 + M) of src [P, C] into the swizzled tile at shared address
  // `dst`, zero past P; every thread of the block; one cp.async group
  __device__ __forceinline__ void load_tile(uint32_t dst,
                                            const bf16* src) const {
    for (int i = threadIdx.x; i < M * VPP; i += 128 * NWG) {
      const int p = i / VPP, c0 = (i - p * VPP) * 8;
      cp_async16(dst + tile_vec(M, p, c0),
                 p0 + p < P ? src + (p0 + p) * C + c0 : nullptr, src);
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void between() { load_tile(a_sm, x); }

  template <int MI, typename Ring>
  __device__ __forceinline__ void run(int s, float (&acc)[NS / 2],
                                      const Ring& ring, int e) {
    const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
    const int row = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    // the tile this product's epilogues read (g; x) was still in flight
    // when its first slab started: this thread's copies, then every thread's
    if (s == 0) cp_async_wait<0>();
    ring.sync_refill(e);
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
      const int c = s * NS + j * 8 + (lane & 3) * 2;
      if constexpr (MI == 0) {
        const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(bc1 + c));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t* at = reinterpret_cast<uint32_t*>(
              gated + (c >> 6) * (M * 128) + swz128(row + 8 * r, c & 63));
          const uint32_t gv = *at;
          *at = pack_bf16(bf_lo(gv) * (acc[4 * j + 2 * r] + bf_lo(b)),
                          bf_hi(gv) * (acc[4 * j + 2 * r + 1] + bf_hi(b)));
        }
      } else {
        const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(bp2 + c));
        const uint32_t ls = __ldg(reinterpret_cast<const uint32_t*>(ls1 + c));
        const float2 sa = __ldg(reinterpret_cast<const float2*>(a1 + c)),
                     sb = __ldg(reinterpret_cast<const float2*>(b1 + c));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t* at = reinterpret_cast<uint32_t*>(
              a + (c >> 6) * (M * 128) + swz128(row + 8 * r, c & 63));
          const uint32_t xv = *at;
          const float x0 = bf_lo(xv), x1 = bf_hi(xv);
          const uint32_t h = pack_bf16(sa.x * x0 + sb.x, sa.y * x1 + sb.y);
          *at = pack_bf16(
              x0 + bf_lo(ls) * (acc[4 * j + 2 * r] + bf_lo(b) + bf_lo(h)),
              x1 + bf_hi(ls) * (acc[4 * j + 2 * r + 1] + bf_hi(b) + bf_hi(h)));
        }
      }
    }
  }
};

// tail: out = x + ls1 * (round(g * (d7 @ wc1^T + bc1)) @ wp2^T + bp2 + h),
// h = round(a1 * x + b1), for the block's pixels. `wpack` holds the slabs of
// wc1, then those of wp2.
template <int C>
__global__ void __launch_bounds__(128 * tail_wgs(C))
    attn_tail_wgmma_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ a1,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ g,
                           const bf16* __restrict__ d7,
                           const unsigned char* __restrict__ wpack,
                           const bf16* __restrict__ bc1,
                           const bf16* __restrict__ bp2,
                           const bf16* __restrict__ ls1,
                           bf16* __restrict__ out, long long P) {
  constexpr int NWG = tail_wgs(C), M = NWG * 64, NS = tail_slab(C);
  constexpr int R = tail_ring(C), VPP = C / 8;
  constexpr Layout L = tail_layout(C);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smp = smem_raw + (sm - smem_u32(smem_raw));
  const int tid = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * M;
  const SlabRing<C, NS, 2 * C / NS, R> ring{sm + L.ring, sm + L.bars, wpack};
  if (tid == 0) ring.start();
  TailEpi<C> epi{x, bc1, bp2, ls1, a1, b1, sm + L.a, smp + L.a, smp + L.a2,
                 p0, P};
  // d7 and g into the two swizzled tiles; the products start when d7 is in
  epi.load_tile(sm + L.a, d7);
  epi.load_tile(sm + L.a2, g);
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();

  float acc[2][NS / 2];
  SlabSteps<C, NS, NWG, 2, R, 0, TailEpi<C>>::run(ring, sm + L.a, sm + L.a2,
                                                  acc, epi);
  // the first tile now holds out: to device memory in 16-byte vectors, a
  // pixel's vectors on neighbouring threads
  __syncthreads();
  for (int i = tid; i < M * VPP; i += 128 * NWG) {
    const int p = i / VPP, c0 = (i - p * VPP) * 8;
    if (p0 + p < P)
      *reinterpret_cast<uint4*>(out + (p0 + p) * C + c0) =
          *reinterpret_cast<const uint4*>(smp + L.a + tile_vec(M, p, c0));
  }
}

// Writes `count` C x C weights ([out, in] bf16, at w0 and w1) as slabs of NS
// output channels, each slab the bytes of a 128-byte swizzled B tile
// [C / 64][NS rows][64]. One thread per 16-byte vector.
template <int C, int NS>
__global__ void attn_pack_kernel(const bf16* __restrict__ w0,
                                 const bf16* __restrict__ w1,
                                 uint4* __restrict__ wpack) {
  constexpr int VECS = C * C / 8;        // of one weight
  constexpr int SLAB_VECS = NS * C / 8;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= VECS) return;
  const bf16* w = blockIdx.y == 0 ? w0 : w1;
  const int s = v / SLAB_VECS, i = v % SLAB_VECS;
  const int kb = i / (NS * 8), r = (i >> 3) % NS, j = (i ^ r) & 7;
  wpack[static_cast<size_t>(blockIdx.y) * VECS + v] =
      __ldg(reinterpret_cast<const uint4*>(
          w + static_cast<size_t>(s * NS + r) * C + kb * 64 + j * 8));
}

template <int C, int NS>
int pack(const void* w0, const void* w1, int count, void* scratch,
         cudaStream_t stream) {
  attn_pack_kernel<C, NS>
      <<<dim3((C * C / 8 + 255) / 256, count), 256, 0, stream>>>(
          static_cast<const bf16*>(w0), static_cast<const bf16*>(w1),
          static_cast<uint4*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_proj1(const void* x, const void* a1, const void* b1,
                 const void* wp1, const void* bp1, void* g, void* scratch,
                 long long P, cudaStream_t stream) {
  int err = pack<C, proj1_slab(C)>(wp1, wp1, 1, scratch, stream);
  if (err != 0) return err;
  constexpr int NWG = proj1_wgs(C);
  const int smem = proj1_layout(C).total + 1024;
  auto kernel = attn_proj1_wgmma_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((P + NWG * 64 - 1) / (NWG * 64));
  kernel<<<blocks, 128 * NWG, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const unsigned char*>(scratch),
      static_cast<const bf16*>(bp1), static_cast<bf16*>(g), P);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_tail(const void* x, const void* a1, const void* b1, const void* g,
                const void* d7, const void* wc1, const void* bc1,
                const void* wp2, const void* bp2, const void* ls1, void* out,
                void* scratch, long long P, cudaStream_t stream) {
  // the slabs of wc1 and wp2 follow those of wp1 in the scratch
  unsigned char* wpack =
      static_cast<unsigned char*>(scratch) + static_cast<size_t>(C) * C * 2;
  int err = pack<C, tail_slab(C)>(wc1, wp2, 2, wpack, stream);
  if (err != 0) return err;
  constexpr int NWG = tail_wgs(C);
  const int smem = tail_layout(C).total + 1024;
  auto kernel = attn_tail_wgmma_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((P + NWG * 64 - 1) / (NWG * 64));
  kernel<<<blocks, 128 * NWG, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const bf16*>(g),
      static_cast<const bf16*>(d7), wpack, static_cast<const bf16*>(bc1),
      static_cast<const bf16*>(bp2), static_cast<const bf16*>(ls1),
      static_cast<bf16*>(out), P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace rs {

bool van_attn_wgmma_takes(int C) {
  return C == 64 || C == 128 || C == 256 || C == 320 || C == 512;
}

size_t van_attn_wgmma_smem_bytes(int C, int tail) {
  return static_cast<size_t>(
             tail ? tail_layout(C).total : proj1_layout(C).total) + 1024;
}

size_t van_attn_wgmma_scratch_bytes(int C) {
  return static_cast<size_t>(3) * C * C * 2;
}

int van_attn_wgmma_proj1(const void* x, const void* a1, const void* b1,
                         const void* wp1, const void* bp1, void* g,
                         void* scratch, long long P, int C,
                         cudaStream_t stream) {
#define RS_ARGS (x, a1, b1, wp1, bp1, g, scratch, P, stream)
  switch (C) {
    case 64: return launch_proj1<64> RS_ARGS;
    case 128: return launch_proj1<128> RS_ARGS;
    case 256: return launch_proj1<256> RS_ARGS;
    case 320: return launch_proj1<320> RS_ARGS;
    case 512: return launch_proj1<512> RS_ARGS;
  }
#undef RS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

int van_attn_wgmma_tail(const void* x, const void* a1, const void* b1,
                        const void* g, const void* d7, const void* wc1,
                        const void* bc1, const void* wp2, const void* bp2,
                        const void* ls1, void* out, void* scratch, long long P,
                        int C, cudaStream_t stream) {
#define RS_ARGS \
  (x, a1, b1, g, d7, wc1, bc1, wp2, bp2, ls1, out, scratch, P, stream)
  switch (C) {
    case 64: return launch_tail<64> RS_ARGS;
    case 128: return launch_tail<128> RS_ARGS;
    case 256: return launch_tail<256> RS_ARGS;
    case 320: return launch_tail<320> RS_ARGS;
    case 512: return launch_tail<512> RS_ARGS;
  }
#undef RS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rs
