// Fused VAN attention half-block (K4) for Hopper (sm_90a): the two
// channel-mixing stages. The two depthwise convs between them are the K5
// kernel (dw_conv_fwd.cu), launched by the same wrapper (ops/van_attn.py).
//
// Replaces: rs_detection_tpu/ops/pallas_van_attn.py, `_attn_kernel` (reached
// through `van_attn`). For x [N, H, W, C] (NHWC, contiguous) and weights as
// nn.Conv2d holds them (1x1 [C, C] = [out, in], depthwise [C, K*K]):
//   h   = round(a1 * x + b1)                      bn1 folded to an affine
//   g   = gelu_erf(round(h @ wp1^T + bp1))        -> device memory   [proj1]
//   d5  = round(dw5(g) + b0)                      K5, zero padding of g
//   d7  = round(dw7 dilation 3 (d5) + bs)         K5, zero padding of d5
//   c1  = d7 @ wc1^T + bc1                                            [tail]
//   p2  = round(g * c1) @ wp2^T + bp2
//   out = x + ls1 * (p2 + h)
// `round` is to the input dtype, at the TPU kernel's storage points
// (pallas_van_attn.py:137, :140, :164, :176, :185); all sums are f32.
//
// Why not one kernel: the TPU kernel keeps x, g and d5 of a 32-row band at
// full width in VMEM (megabytes). A Hopper block has 227 KB, and the chain
// couples every channel (the 1x1 convs) with an 11-pixel neighbourhood (the
// depthwise convs): a 16x16 output tile has a 38x38 haloed tile, 5.6 x the
// proj_1 work. So the function is cut where the coupling changes: `proj1`
// and `tail` are per-pixel and see all channels, the depthwise stage is
// per-channel and sees a neighbourhood. That is four launches per half-block
// and x read twice, g written once and read twice, d5 and d7 written and read
// once, against about fifteen passes for the plain chain.
//
// What bounds it on the H100: per forward of VAN-b3 at batch 8, 1024^2 the
// three C x C products are 0.69 TFLOP (0.7 ms at the bf16 tensor-core peak)
// and the traffic of the two stages here about 5 GB (1.4 ms); these kernels
// run WMMA 16x16x16 fragments fed from shared memory, so what bounds this
// version is the shared-memory fragment loads and the per-chunk barriers, not
// HBM. That is the first design, which this file keeps for f32 and for bf16
// widths other than VAN's; bf16 at C in {64, 128, 256, 320, 512} runs the
// wgmma design of van_attn_wgmma.cu (the launchers below pick by shape). In
// the first design a block owns 64 consecutive pixels (32 in f32): the
// activation tile sits in shared memory, the weights stream through in chunks
// of 32 output channels by cp.async, and each warp owns a 16-pixel x
// 16-channel tile per chunk, summed in two independent accumulators. The kernels are
// latency-bound (a barrier and a chain of dependent tensor-core operations
// per chunk), so the weights take one staging buffer or two, whichever lets
// more blocks share an SM. In `tail` the gated product round(g * c1) is
// written to a second shared tile and never leaves the SM. The f32 form
// (tests and small shapes) uses plain FMAs.

#include <mma.h>

#include "rs_common.cuh"
#include "van_attn.cuh"

namespace {

using namespace rs;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NC = 32;  // output channels per weight chunk

// pixels per block
template <typename T> __host__ __device__ constexpr int tile_m() {
  return sizeof(T) == 2 ? 64 : 32;
}
// Row strides: bf16 rows are padded by 8 elements (WMMA wants a multiple of
// 8 and 32-byte aligned fragments); f32 rows by one element, which spreads
// the FMA path's strided reads over all 32 banks.
template <typename T> __host__ __device__ constexpr int ld_of(int c) {
  return sizeof(T) == 2 ? c + 8 : c + 1;
}

struct Layout {
  size_t a, a2, w, stg, total;
  size_t w_buf;  // bytes between the weight staging buffers
};

// `tiles` activation tiles (1 for proj1, 2 for tail), `nbuf` weight buffers.
template <typename T>
__host__ __device__ inline Layout layout_of(int c, int tiles, int nbuf) {
  Layout l;
  const size_t tile = up128(static_cast<size_t>(tile_m<T>()) * ld_of<T>(c) *
                            sizeof(T));
  l.a = 0;
  l.a2 = tile;
  l.w = tiles * tile;
  l.w_buf = up128(static_cast<size_t>(NC) * ld_of<T>(c) * sizeof(T));
  l.stg = l.w + nbuf * l.w_buf;
  l.total = l.stg + (sizeof(T) == 2 ? WARPS * 256 * sizeof(float) : 0);
  return l;
}

// Weight staging buffers: the count that lets most blocks share an SM (the
// kernels are latency-bound, and a second block hides the barriers of the
// first); two, which overlap the copy with the products, on a tie.
template <typename T> int pick_nbuf(int c, int tiles) {
  int dev = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  const size_t limit = static_cast<size_t>(smem_optin_limit());
  auto blocks = [&](int nbuf) {
    const size_t need = layout_of<T>(c, tiles, nbuf).total;
    // CUDA reserves 1 KB of shared memory per resident block
    return need <= limit ? static_cast<size_t>(per_sm) / (need + 1024) : 0;
  };
  return blocks(2) >= blocks(1) ? 2 : 1;
}

// Copies weight rows [o0, o0 + NC) of wg [C][C] (row = output channel) into
// wb [NC][ld], zero past C.
template <typename T>
__device__ __forceinline__ void stage_weights(T* wb, const T* wg, int o0,
                                              int C, int ld) {
  if (sizeof(T) == 2) {
    const int vpr = C / 8;  // C % 32 == 0 in bf16
    copy_vec16(
        NC * vpr, wg,
        [&](int i) {
          const int j = i / vpr;
          return wg + static_cast<size_t>(o0 + j) * C + (i - j * vpr) * 8;
        },
        [&](int i) {
          const int j = i / vpr;
          return wb + j * ld + (i - j * vpr) * 8;
        });
  } else {
    for (int i = threadIdx.x; i < NC * C; i += THREADS) {
      const int j = i / C;
      const int c = i - j * C;
      wb[j * ld + c] =
          o0 + j < C ? wg[static_cast<size_t>(o0 + j) * C + c] : from_f<T>(0.f);
    }
  }
}

// Runs `nmat` chained C x C products over the block's pixel tile. Product m
// multiplies the tile a_of(m) [M][ld] by w_of(m)^T, and epi(m, p, o, s) gets
// the f32 sum s of tile pixel p and output channel o. Every warp passes a
// block barrier before each chunk, so what epi(m, ...) wrote to shared
// memory is visible to product m + 1.
template <typename T, typename AOf, typename WOf, typename Epi>
__device__ __forceinline__ void pixel_products(unsigned char* smem,
                                               const Layout& L, int C,
                                               int nbuf, int nmat, AOf a_of,
                                               WOf w_of, Epi epi) {
  using namespace nvcuda;
  constexpr int M = tile_m<T>();
  const int ld = ld_of<T>(C);
  const int chunks = (C + NC - 1) / NC;
  const int steps = nmat * chunks;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  auto wbuf = [&](int b) {
    return reinterpret_cast<T*>(smem + L.w + b * L.w_buf);
  };
  stage_weights(wbuf(0), w_of(0), 0, C, ld);
  for (int it = 0; it < steps; ++it) {
    const int m = it / chunks;
    const int o0 = (it - m * chunks) * NC;
    const int buf = nbuf == 2 ? (it & 1) : 0;
    cp_async_wait_all();
    // this chunk's weights have landed, and every warp is done with the
    // previous chunk (its buffer may be overwritten, its epilogue is visible)
    __syncthreads();
    if (nbuf == 2 && it + 1 < steps) {
      const int m1 = (it + 1) / chunks;
      stage_weights(wbuf(buf ^ 1), w_of(m1), (it + 1 - m1 * chunks) * NC, C,
                    ld);
    }
    const T* as = a_of(m);
    const T* ws = wbuf(buf);
    if constexpr (sizeof(T) == 2) {
      // warp (mi, half): pixels [16 mi, 16 mi + 16), channels o0 + 16 half
      const int mi = warp & 3;
      const int half = warp >> 2;
      // two accumulators over alternate k steps (C % 32 == 0): two
      // independent chains of dependent tensor-core operations
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc, acc1;
      wmma::fill_fragment(acc, 0.f);
      wmma::fill_fragment(acc1, 0.f);
      for (int kk = 0; kk < C; kk += 32) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a, a1;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b, b1;
        wmma::load_matrix_sync(a, as + mi * 16 * ld + kk, ld);
        wmma::load_matrix_sync(b, ws + half * 16 * ld + kk, ld);
        wmma::load_matrix_sync(a1, as + mi * 16 * ld + kk + 16, ld);
        wmma::load_matrix_sync(b1, ws + half * 16 * ld + kk + 16, ld);
        wmma::mma_sync(acc, a, b, acc);
        wmma::mma_sync(acc1, a1, b1, acc1);
      }
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc1.x[i];
      float* tile = reinterpret_cast<float*>(smem + L.stg) + warp * 256;
      wmma::store_matrix_sync(tile, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        epi(m, mi * 16 + (e >> 4), o0 + half * 16 + (e & 15), tile[e]);
      __syncwarp();
    } else {
      for (int i = threadIdx.x; i < M * NC; i += THREADS) {
        const int p = i / NC;
        const int j = i - p * NC;
        if (o0 + j >= C) continue;
        const T* ar = as + p * ld;
        const T* wr = ws + j * ld;
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += to_f(ar[c]) * to_f(wr[c]);
        epi(m, p, o0 + j, s);
      }
    }
    if (nbuf == 1 && it + 1 < steps) {
      __syncthreads();  // every warp is done reading this chunk's buffer
      const int m1 = (it + 1) / chunks;
      stage_weights(wbuf(0), w_of(m1), (it + 1 - m1 * chunks) * NC, C, ld);
    }
  }
}

// proj1: g = gelu_erf(round(round(a1 * x + b1) @ wp1^T + bp1)) for pixels
// [p0, p0 + M) of the P = N * H * W pixels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    attn_proj1_kernel(const T* __restrict__ x, const float* __restrict__ a1,
                      const float* __restrict__ b1, const T* __restrict__ wp1,
                      const T* __restrict__ bp1, T* __restrict__ g,
                      long long P, int C, int nbuf) {
  constexpr int M = tile_m<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_of<T>(C, 1, nbuf);
  const int ld = ld_of<T>(C);
  T* as = reinterpret_cast<T*>(smem + L.a);
  const long long p0 = static_cast<long long>(blockIdx.x) * M;
  for (int i = threadIdx.x; i < M * C; i += THREADS) {
    const int p = i / C;
    const int c = i - p * C;
    float v = 0.f;
    if (p0 + p < P) v = a1[c] * to_f(x[(p0 + p) * C + c]) + b1[c];
    as[p * ld + c] = from_f<T>(v);
  }
  pixel_products<T>(
      smem, L, C, nbuf, 1, [&](int) { return as; }, [&](int) { return wp1; },
      [&](int, int p, int o, float s) {
        if (p0 + p < P)
          g[(p0 + p) * C + o] =
              from_f<T>(gelu_erf(round_to<T>(s + to_f(bp1[o]))));
      });
}

// tail: out = x + ls1 * (round(g * (d7 @ wc1^T + bc1)) @ wp2^T + bp2 + h),
// h = round(a1 * x + b1), for pixels [p0, p0 + M).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    attn_tail_kernel(const T* __restrict__ x, const float* __restrict__ a1,
                     const float* __restrict__ b1, const T* __restrict__ g,
                     const T* __restrict__ d7, const T* __restrict__ wc1,
                     const T* __restrict__ bc1, const T* __restrict__ wp2,
                     const T* __restrict__ bp2, const T* __restrict__ ls1,
                     T* __restrict__ out, long long P, int C, int nbuf) {
  constexpr int M = tile_m<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout_of<T>(C, 2, nbuf);
  const int ld = ld_of<T>(C);
  T* as = reinterpret_cast<T*>(smem + L.a);
  T* gated = reinterpret_cast<T*>(smem + L.a2);
  const long long p0 = static_cast<long long>(blockIdx.x) * M;
  for (int i = threadIdx.x; i < M * C; i += THREADS) {
    const int p = i / C;
    const int c = i - p * C;
    as[p * ld + c] = p0 + p < P ? d7[(p0 + p) * C + c] : from_f<T>(0.f);
  }
  pixel_products<T>(
      smem, L, C, nbuf, 2, [&](int m) { return m == 0 ? as : gated; },
      [&](int m) { return m == 0 ? wc1 : wp2; },
      [&](int m, int p, int o, float s) {
        const bool in = p0 + p < P;
        const long long at = (p0 + p) * C + o;
        if (m == 0) {
          const float gv = in ? to_f(g[at]) : 0.f;
          gated[p * ld + o] = from_f<T>(gv * (s + to_f(bc1[o])));
        } else if (in) {
          const float xv = to_f(x[at]);
          const float h = round_to<T>(a1[o] * xv + b1[o]);
          out[at] = from_f<T>(xv + to_f(ls1[o]) * (s + to_f(bp2[o]) + h));
        }
      });
}

bool width_supported(int C, int dtype) {
  return C > 0 && (dtype == 0 || (dtype == 1 && C % 32 == 0));
}

template <typename T>
int launch_proj1(const void* x, const void* a1, const void* b1,
                 const void* wp1, const void* bp1, void* g, long long P,
                 int C, cudaStream_t stream) {
  const int nbuf = pick_nbuf<T>(C, 1);
  const size_t smem = layout_of<T>(C, 1, nbuf).total;
  auto kernel = attn_proj1_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks =
      static_cast<unsigned>((P + tile_m<T>() - 1) / tile_m<T>());
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const T*>(wp1),
      static_cast<const T*>(bp1), static_cast<T*>(g), P, C, nbuf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tail(const void* x, const void* a1, const void* b1, const void* g,
                const void* d7, const void* wc1, const void* bc1,
                const void* wp2, const void* bp2, const void* ls1, void* out,
                long long P, int C, cudaStream_t stream) {
  const int nbuf = pick_nbuf<T>(C, 2);
  const size_t smem = layout_of<T>(C, 2, nbuf).total;
  auto kernel = attn_tail_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks =
      static_cast<unsigned>((P + tile_m<T>() - 1) / tile_m<T>());
  kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a1),
      static_cast<const float*>(b1), static_cast<const T*>(g),
      static_cast<const T*>(d7), static_cast<const T*>(wc1),
      static_cast<const T*>(bc1), static_cast<const T*>(wp2),
      static_cast<const T*>(bp2), static_cast<const T*>(ls1),
      static_cast<T*>(out), P, C, nbuf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Which design runs a half-block of this width: 0 = none takes it, 1 = the
// first design (f32: any width; bf16: C % 32 == 0), 2 = the wgmma design.
// dtype: 0 = f32, 1 = bf16.
extern "C" int rs_van_attn_design(int C, int dtype) {
  if (!width_supported(C, dtype)) return 0;
  return dtype == 1 && rs::van_attn_wgmma_takes(C) ? 2 : 1;
}

// Shared memory one block of the stage that needs more asks for, or 0 if the
// width is not supported.
extern "C" size_t rs_van_attn_smem_bytes(int C, int dtype) {
  switch (rs_van_attn_design(C, dtype)) {
    case 2: {
      const size_t proj1 = rs::van_attn_wgmma_smem_bytes(C, 0);
      const size_t tail = rs::van_attn_wgmma_smem_bytes(C, 1);
      return proj1 > tail ? proj1 : tail;
    }
    case 1:
      if (dtype == 0)
        return layout_of<float>(C, 2, pick_nbuf<float>(C, 2)).total;
      return layout_of<__nv_bfloat16>(C, 2, pick_nbuf<__nv_bfloat16>(C, 2))
          .total;
  }
  return 0;
}

// Bytes of device scratch the two stages of one half-block share (0 where
// the design needs none).
extern "C" size_t rs_van_attn_scratch_bytes(int C, int dtype) {
  return rs_van_attn_design(C, dtype) == 2
             ? rs::van_attn_wgmma_scratch_bytes(C)
             : 0;
}

// x, g: [P, C] of `dtype`; a1, b1: [C] f32; wp1: [C, C]; bp1: [C]; `scratch`:
// rs_van_attn_scratch_bytes() bytes, 16-byte aligned (may be null where that
// is 0). Launches on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int rs_van_attn_proj1(const void* x, const void* a1, const void* b1,
                                 const void* wp1, const void* bp1, void* g,
                                 void* scratch, long long P, int C, int dtype,
                                 void* stream) {
  const int design = rs_van_attn_design(C, dtype);
  if (P < 1 || design == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 2)
    return rs::van_attn_wgmma_proj1(x, a1, b1, wp1, bp1, g, scratch, P, C, st);
  if (dtype == 0)
    return launch_proj1<float>(x, a1, b1, wp1, bp1, g, P, C, st);
  return launch_proj1<__nv_bfloat16>(x, a1, b1, wp1, bp1, g, P, C, st);
}

// x, g, d7, out: [P, C] of `dtype` (out must not alias them); a1, b1: [C]
// f32; wc1, wp2: [C, C]; bc1, bp2, ls1: [C]; `scratch` as for proj1 (the same
// buffer: each stage packs its own weights into its own part).
extern "C" int rs_van_attn_tail(const void* x, const void* a1, const void* b1,
                                const void* g, const void* d7, const void* wc1,
                                const void* bc1, const void* wp2,
                                const void* bp2, const void* ls1, void* out,
                                void* scratch, long long P, int C, int dtype,
                                void* stream) {
  const int design = rs_van_attn_design(C, dtype);
  if (P < 1 || design == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 2)
    return rs::van_attn_wgmma_tail(x, a1, b1, g, d7, wc1, bc1, wp2, bp2, ls1,
                                   out, scratch, P, C, st);
  if (dtype == 0)
    return launch_tail<float>(x, a1, b1, g, d7, wc1, bc1, wp2, bp2, ls1, out,
                              P, C, st);
  return launch_tail<__nv_bfloat16>(x, a1, b1, g, d7, wc1, bc1, wp2, bp2, ls1,
                                    out, P, C, st);
}
