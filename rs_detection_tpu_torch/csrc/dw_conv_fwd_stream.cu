// Depthwise K x K dilated convolution forward (K5) for Hopper (sm_90a), as a
// kernel that streams down the rows of a column strip.
//
// Replaces: rs_detection_tpu/ops/pallas_dwconv.py, `_dw_kernel` (reached
// through `depthwise_conv2d`), for bf16 NHWC at the two kernels of VAN's
// attention, (K, d) = (5, 1) and (7, 3): the 5x5 and the dilated 7x7 of the
// fused attention half-block (ops/van_attn.py), with their biases. It
// computes what dw_conv_fwd.cu computes (SAME zero padding, stride 1):
//   y[n, r, q, c] = bias[c] + sum_{ky,kx} xpad[n, r + ky*d, q + kx*d, c]
//                                         * w[ky*K + kx, c]
// with the taps summed in f32 and one rounding to bf16. The first design
// (dw_conv_fwd.cu) stays for f32, K = 3, other dilations and K7's layout.
//
// What bounds it on the H100: the f32 FMA pipe (K*K multiply-adds per
// output and channel, 67 TFLOP/s), if nothing else takes issue slots. The
// first design spent them on shared memory: one bf16 channel per lane (a
// 2-byte load, half a wavefront per warp) and 17.5 loads per output at
// K = 7; and it staged a haloed 30 x 34 tile for 12 x 16 outputs at (7, 3),
// 5.3x the outputs read from L2 or HBM, with no overlap of loads and sums.
// This design:
//   - A block owns G * Q output columns (a strip) x 64 channels of one
//     image and one residue class of rows mod d, and walks down the rows of
//     that class (or a segment of them): with dilation d an output row of
//     class rho reads only input rows of class (rho - pad) mod d, so rows
//     of one class are a plain K x K convolution along the rows. Each
//     input row of the class arrives once per strip, by 16-byte cp.async
//     with zero fill (the SAME padding and the image's edges), into a ring
//     of 3R + K - 1 row slots: the rows of the next two steps of R rows
//     load while this step's are summed, one barrier per step. Only the
//     horizontal halo is read again: (TW + (K-1)d) / TW, 1.75x at (7, 3)
//     with TW = 24, against 5.3x.
//   - A lane owns 2 channels (a 4-byte bf16x2 load, one wavefront per
//     warp), a warp one group of Q = 4 columns spaced d apart, and a thread
//     R = 4 rows x Q columns of outputs spaced d apart, so each value loaded
//     feeds up to min(R, K) * min(Q, K) taps: (R+K-1)(Q+K-1) = 100 loads for
//     784 multiply-adds per channel at K = 7 (49 per 2.8 loads before). The
//     K*K taps of the lane's two channels stay in registers as f32; they
//     come in once per block through shared memory, in address order.
// The plan (G, the strip, the row segments) comes from ops/dwconv.py:dw_plan.

#include <stdint.h>

#include "rs_common.cuh"

namespace {

using namespace rs;

constexpr int R = 4;    // output rows per thread, d apart
constexpr int Q = 4;    // output columns per thread, d apart
constexpr int CB = 64;  // channels per block: 2 per lane
constexpr int STAGES = 3;  // steps of R rows in the ring: this one, 2 ahead

template <int K, int D, int G> struct StreamGeom {
  static constexpr int TW = G * Q;                // output columns per strip
  static constexpr int IW = TW + (K - 1) * D;     // staged columns
  static constexpr int RING = STAGES * R + K - 1;  // row slots
  static constexpr int THREADS = 32 * G;
  static constexpr size_t RING_BYTES =
      static_cast<size_t>(RING) * IW * CB * sizeof(__nv_bfloat16);
  // the ring, then the block's taps as f32 [K*K][CB]
  static constexpr size_t SMEM = RING_BYTES + K * K * CB * sizeof(float);
};

template <int K, int D, int G>
__global__ void __launch_bounds__(StreamGeom<K, D, G>::THREADS, 2)
    dw_stream_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int H, int W, int C,
                     long long w_tap, long long w_ch, int strips, int segs,
                     int seg_steps) {
  using Gm = StreamGeom<K, D, G>;
  static_assert(G % D == 0, "a strip holds whole column groups");
  constexpr int PAD = D * (K - 1) / 2;
  constexpr int VPP = CB / 8;  // 16-byte vectors per staged pixel
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  // block -> (image, channel chunk, strip, row class, segment)
  int b = blockIdx.x;
  const int seg = b % segs;
  b /= segs;
  const int rho = b % D;
  b /= D;
  const int strip = b % strips;
  b /= strips;
  const int cchunks = (C + CB - 1) / CB;
  const int cc = b % cchunks;
  const int n = b / cchunks;
  const int x0 = strip * Gm::TW;
  const int c0 = cc * CB;
  const int rows_rho = (H - rho + D - 1) / D;  // output rows of the class
  const int t_begin = seg * seg_steps * R;
  const int t_end = min(rows_rho, t_begin + seg_steps * R);
  if (t_begin >= t_end) return;  // block-uniform
  const size_t img = static_cast<size_t>(n) * H * W * C;

  // input row u of the class is image row rho - PAD + D * u, in slot
  // u % RING. A staged row is IW * VPP 16-byte vectors; thread i copies
  // vectors i, i + THREADS, ... of every row, whose column and channels are
  // the same in every row: their offsets are worked out once.
  constexpr int ROW_VECS = Gm::IW * VPP;
  constexpr int NV = (ROW_VECS + Gm::THREADS - 1) / Gm::THREADS;
  int src_off[NV], dst_off[NV];  // -1: zero fill / not this thread's
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int q = threadIdx.x + j * Gm::THREADS;
    const int col = q / VPP;
    const int c = c0 + (q % VPP) * 8;
    const int gx = x0 - PAD + col;
    dst_off[j] = q < ROW_VECS ? q * 8 : -1;
    src_off[j] = gx >= 0 && gx < W && c < C ? gx * C + c : -1;
  }
  auto load_rows = [&](int u0, int count) {
    for (int u = u0; u < u0 + count; ++u) {
      const int gy = rho - PAD + D * u;
      const bool row_in = gy >= 0 && gy < H;
      const __nv_bfloat16* src = x + img + static_cast<size_t>(gy) * W * C;
      __nv_bfloat16* dst =
          ring + static_cast<size_t>(u % Gm::RING) * Gm::IW * CB;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (dst_off[j] >= 0)
          cp_async16(dst + dst_off[j],
                     row_in && src_off[j] >= 0 ? src + src_off[j] : nullptr,
                     x);
    }
    cp_async_commit();
  };

  // step s reads rows [s R, s R + R + K - 1) of the segment; its last R
  // rows (all of them for the first step) arrive in its own group
  load_rows(t_begin, R + K - 1);
  for (int s = 1; s < STAGES - 1; ++s) {
    const int t = t_begin + s * R;
    if (t < t_end)
      load_rows(t + K - 1, R);
    else
      cp_async_commit();  // an empty group keeps the count of the wait
  }

  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const int ch = c0 + 2 * lane;  // C is even: ch < C covers ch + 1
  // this warp's first output column within the strip
  const int cs = (grp / D) * Q * D + grp % D;
  // the block's taps pass through shared memory, read in the order of
  // their addresses: read straight into registers, [C, K*K] taps put the
  // lanes K*K elements apart, and every warp would fetch them all again
  float* wsm = reinterpret_cast<float*>(smem + Gm::RING_BYTES);
  for (int i = threadIdx.x; i < K * K * CB; i += Gm::THREADS) {
    const bool taps_inner = w_tap == 1;
    const int c = taps_inner ? i / (K * K) : i % CB;
    const int t = taps_inner ? i % (K * K) : i / CB;
    wsm[t * CB + c] =
        c0 + c < C ? to_f(w[t * w_tap + (c0 + c) * w_ch]) : 0.f;
  }
  __syncthreads();
  float wr[K * K][2];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    const float2 v = *reinterpret_cast<const float2*>(wsm + t * CB + 2 * lane);
    wr[t][0] = v.x;
    wr[t][1] = v.y;
  }
  const float b0 = (bias != nullptr && ch < C) ? to_f(bias[ch]) : 0.f;
  const float b1 = (bias != nullptr && ch < C) ? to_f(bias[ch + 1]) : 0.f;
  const __nv_bfloat16* lane_base = ring + cs * CB + 2 * lane;

  for (int t = t_begin; t < t_end; t += R) {
    cp_async_wait<STAGES - 2>();
    // this step's rows have landed for every thread, and every thread is
    // done with the previous step, whose first R slots the next loads take
    __syncthreads();
    const int ahead = t + (STAGES - 1) * R;
    if (ahead < t_end)
      load_rows(ahead + K - 1, R);
    else
      cp_async_commit();

    float acc[R][Q][2];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        acc[i][j][0] = b0;
        acc[i][j][1] = b1;
      }
    int slot = t % Gm::RING;
#pragma unroll
    for (int a = 0; a < R + K - 1; ++a) {
      const __nv_bfloat16* row =
          lane_base + static_cast<size_t>(slot) * Gm::IW * CB;
      slot = slot + 1 == Gm::RING ? 0 : slot + 1;
#pragma unroll
      for (int bb = 0; bb < Q + K - 1; ++bb) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + bb * D * CB));
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int ky = a - i;
          if (ky < 0 || ky >= K) continue;
#pragma unroll
          for (int j = 0; j < Q; ++j) {
            const int kx = bb - j;
            if (kx < 0 || kx >= K) continue;
            acc[i][j][0] = fmaf(v.x, wr[ky * K + kx][0], acc[i][j][0]);
            acc[i][j][1] = fmaf(v.y, wr[ky * K + kx][1], acc[i][j][1]);
          }
        }
      }
    }

    if (ch < C) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (t + i >= t_end) break;
        const int gy = rho + D * (t + i);
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const int gx = x0 + cs + j * D;
          if (gx >= W) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              y + img + (static_cast<size_t>(gy) * W + gx) * C + ch) =
              __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
        }
      }
    }
  }
}

template <int K, int D, int G>
int launch(const void* x, const void* w, const void* bias, void* y, int N,
           int H, int W, int C, long long w_tap, long long w_ch, int segs,
           int seg_steps, cudaStream_t stream) {
  using Gm = StreamGeom<K, D, G>;
  if (Gm::SMEM > static_cast<size_t>(smem_optin_limit()))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dw_stream_kernel<K, D, G>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Gm::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int strips = (W + Gm::TW - 1) / Gm::TW;
  const long long blocks = static_cast<long long>(N) * ((C + CB - 1) / CB) *
                           strips * D * segs;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), Gm::THREADS, Gm::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y),
      H, W, C, w_tap, w_ch, strips, segs, seg_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one block of the streaming design for (k, d) and `groups`
// warps, 0 for a combination it is not built for.
extern "C" size_t rs_dw_conv_fwd_stream_smem_bytes(int k, int d, int groups) {
  if (k == 5 && d == 1 && groups == 8) return StreamGeom<5, 1, 8>::SMEM;
  if (k == 7 && d == 3 && groups == 6) return StreamGeom<7, 3, 6>::SMEM;
  return 0;
}

// x, y: contiguous bf16 [N, H, W, C], C % 8 == 0, x 16-byte aligned; w: tap
// t of channel c at w[t * w_tap + c * w_ch]; bias [C] or null; y must not
// alias x. groups: warps per block (a strip of 4 * groups columns); each
// (image, channel chunk, strip, row class) walks its rows in `segs`
// segments of `seg_steps` steps of 4 rows (ops/dwconv.py:dw_plan). Returns
// cudaGetLastError() (0 = success).
extern "C" int rs_dw_conv_fwd_stream(const void* x, const void* w,
                                     const void* bias, void* y, int N, int H,
                                     int W, int C, int k, int d,
                                     long long w_tap, long long w_ch,
                                     int groups, int segs, int seg_steps,
                                     void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 8 || C % 8 || segs < 1 ||
      seg_steps < 1 || reinterpret_cast<uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 5 && d == 1 && groups == 8)
    return launch<5, 1, 8>(x, w, bias, y, N, H, W, C, w_tap, w_ch, segs,
                           seg_steps, st);
  if (k == 7 && d == 3 && groups == 6)
    return launch<7, 3, 6>(x, w, bias, y, N, H, W, C, w_tap, w_ch, segs,
                           seg_steps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
