// Depthwise K x K dilated convolution forward in the [N, H, C, W] layout
// (K7's form) for Hopper (sm_90a), as a warp that streams down one channel's
// rows with its taps, inputs and sums in registers.
//
// Replaces: tools/analysis_tools/chw_dw_proto.py, `_dw_kernel` (reached
// through `dw_chw`), for bf16 with W a multiple of 8, 16-byte aligned, K in
// {3, 5, 7} and dilation 1, 2 or 3. It computes what the first design
// (dw_conv_fwd.cu, HCW = true) computes, SAME zero padding, stride 1:
//   y[n, r, c, q] = bias[c] + sum_{ky,kx} xpad[n, r + ky*d, c, q + kx*d]
//                                         * w[ky*K + kx, c]
// with the taps summed in f32 and one rounding to bf16. The first design
// stays for f32, other dilations, ragged W and as the reference this one is
// timed against (ops/dwconv.py:dw_chw_first_design).
//
// What bounds it on the H100, at the prototype's [8, 256, 64, 256]: dw5 its
// bytes (x read and y written once, 134 MB: 0.040 ms), dw7d3 its 49 FFMA per
// element (0.049 ms at 67 TFLOP/s); 0.089 ms for the pair. The first design
// (1.0 ms for the pair) staged a haloed 30 x 50 tile of 8 channels in shared
// memory for 12 x 32 outputs at (7, 3) (3.9x its outputs), by scalar 2-byte
// loads, and read every tap operand from shared memory. In this layout one
// channel's row is contiguous, W = 256 bf16 is one 16-byte vector per lane
// of a warp, and the channel is the same across the warp. So:
//   - A warp owns one channel, a strip of 256 columns (8 per lane) and one
//     residue class of rows mod d (or a segment of its rows: ops/dwconv.py
//     picks the segments), and walks down the class: with dilation d an
//     output row of class rho reads only input rows of one class, a plain
//     K x K convolution along them. Each input row is read once per strip
//     from device memory, as 16-byte vectors, the next row's in flight under
//     this row's sums (more rows in flight measured no faster); the
//     (K-1)d/2 halo columns on each side come from the neighbouring lanes'
//     vectors by 4-byte or 16-byte loads that the L1 serves (only the words
//     a lane needs).
//   - The row's values are converted to f32 once and feed K x K taps: the K
//     output rows that an input row touches keep their 8 f32 sums per lane in
//     registers, shifted by one row after each input row. A ring of K rows in
//     a loop unrolled K times needs no shift but measured slower at (7, 3)
//     (0.122 against 0.106 ms), with a 3,800-instruction loop body against
//     ~900 instructions for the whole kernel.
//   - The channel's K*K taps and bias stay in registers as f32.
// Registers at (7, 3): 56 sums, 49 taps, 26 values, 14 words in flight (168
// a thread, three blocks of 4 warps an SM). 0.18 ms for the pair
// (tools/k1k7_designs.py, NVIDIA H100 80GB HBM3 at 700 W).

#include <stdint.h>

#include "rs_common.cuh"

namespace {

using namespace rs;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;  // independent warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int STRIP = 256;  // output columns per warp: 8 per lane

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The words of the 16-byte vectors a lane reads per row: vector v covers
// columns 8 * (lane + v - HV) .. + 7 of its strip; value m of the lane's
// window is column 8 * lane - PAD + m, m < 8 + 2 * PAD.
template <int K, int D> struct ChwGeom {
  static constexpr int PAD = D * (K - 1) / 2;
  static constexpr int HV = (PAD + 7) / 8;   // halo vectors on each side
  static constexpr int NV = 2 * HV + 1;       // vectors per row
  static constexpr int NVAL = 8 + 2 * PAD;    // values used per row
  // window index of element e of vector v (in range or not)
  __host__ __device__ static constexpr int m_of(int v, int e) {
    return 8 * (v - HV) + e + PAD;
  }
  __host__ __device__ static constexpr bool word_used(int v, int wi) {
    return (m_of(v, 2 * wi) >= 0 && m_of(v, 2 * wi) < NVAL) ||
           (m_of(v, 2 * wi + 1) >= 0 && m_of(v, 2 * wi + 1) < NVAL);
  }
  __host__ __device__ static constexpr bool vec_full(int v) {
    return word_used(v, 0) && word_used(v, 1) && word_used(v, 2) &&
           word_used(v, 3);
  }
};

// The words of one input row that this lane needs, zero outside the image:
// `row` points at the lane's first column of the row, `in[v]` says whether
// vector v lies inside the image.
template <int K, int D>
__device__ __forceinline__ void load_row(const bf16* row,
                                         const bool (&in)[ChwGeom<K, D>::NV],
                                         uint32_t (&r)[ChwGeom<K, D>::NV][4]) {
  using G = ChwGeom<K, D>;
#pragma unroll
  for (int v = 0; v < G::NV; ++v) {
    const bf16* p = row + 8 * (v - G::HV);
    if (G::vec_full(v)) {
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (in[v]) q = __ldg(reinterpret_cast<const uint4*>(p));
      r[v][0] = q.x, r[v][1] = q.y, r[v][2] = q.z, r[v][3] = q.w;
    } else {
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        r[v][wi] = 0u;
        if (G::word_used(v, wi) && in[v])
          r[v][wi] = __ldg(reinterpret_cast<const unsigned*>(p) + wi);
      }
    }
  }
}

template <int K, int D>
__global__ void __launch_bounds__(THREADS, 3)
    dw_chw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, bf16* __restrict__ y, int N,
                  int H, int W, int C, long long w_tap, long long w_ch,
                  int strips, int segs, int seg_rows) {
  using G = ChwGeom<K, D>;
  const int lane = threadIdx.x & 31;
  // task -> (image, segment, row class, strip, channel), channel fastest:
  // neighbouring warps read neighbouring rows of memory (fewer than 2^31
  // tasks: the launcher checks)
  unsigned t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int c = static_cast<int>(t % C);
  t /= C;
  const int strip = static_cast<int>(t % strips);
  t /= strips;
  const int rho = static_cast<int>(t % D);
  t /= D;
  const int seg = static_cast<int>(t % segs);
  const int n = static_cast<int>(t / segs);
  if (n >= N) return;  // warp-uniform
  const int rows_rho = (H - rho + D - 1) / D;  // output rows of the class
  const int i0 = seg * seg_rows;
  const int i1 = min(rows_rho, i0 + seg_rows);
  if (i0 >= i1) return;
  const int col = strip * STRIP + 8 * lane;

  float wr[K * K];
#pragma unroll
  for (int k = 0; k < K * K; ++k) wr[k] = to_f(w[k * w_tap + c * w_ch]);
  const float bv = bias != nullptr ? to_f(bias[c]) : 0.f;
  float acc[K][8];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[s][e] = bv;
  // the lane's vectors inside the image's columns: the same in every row
  bool col_in[G::NV];
#pragma unroll
  for (int v = 0; v < G::NV; ++v) {
    const int cv = col + 8 * (v - G::HV);
    col_in[v] = cv >= 0 && cv < W;
  }

  // input row u of the segment is image row rho - PAD + D * (i0 + u); output
  // i0 + i reads inputs u = i .. i + K - 1 (tap row u - i). Rows and
  // offsets advance by one row of the class per input.
  const int n_in = (i1 - i0) + K - 1;
  const long long plane = static_cast<long long>(C) * W;  // one image row
  const long long step = D * plane;
  const long long chan =
      static_cast<long long>(n) * H * plane + static_cast<long long>(c) * W +
      col;
  int gy = rho - G::PAD + D * i0;
  long long x_off = chan + gy * plane;
  long long y_off = chan + (rho + D * i0) * plane;
  auto fetch = [&](uint32_t (&r)[G::NV][4]) {
    bool in[G::NV];
    const bool row_in = static_cast<unsigned>(gy) < static_cast<unsigned>(H);
#pragma unroll
    for (int v = 0; v < G::NV; ++v) in[v] = row_in && col_in[v];
    load_row<K, D>(x + (row_in ? x_off : chan), in, r);
    gy += D;
    x_off += step;
  };
  uint32_t cur[G::NV][4];
  fetch(cur);
  for (int u = 0; u < n_in; ++u) {
    uint32_t nxt[G::NV][4];
    fetch(nxt);  // row u + 1, in flight under row u's sums
    float val[G::NVAL];
#pragma unroll
    for (int v = 0; v < G::NV; ++v)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int m = G::m_of(v, e);
        if (m >= 0 && m < G::NVAL)
          val[m] = __uint_as_float(e & 1 ? cur[v][e / 2] & 0xffff0000u
                                         : cur[v][e / 2] << 16);
      }
    // acc[K - 1 - ky] holds output u - ky
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[K - 1 - ky][e] =
              fmaf(val[e + kx * D], wr[ky * K + kx], acc[K - 1 - ky][e]);
    // output u - (K - 1) has all its rows: store it, shift the rest
    if (u >= K - 1) {
      if (col_in[G::HV]) {
        uint4 o;
        o.x = pack_bf16x2(acc[0][0], acc[0][1]);
        o.y = pack_bf16x2(acc[0][2], acc[0][3]);
        o.z = pack_bf16x2(acc[0][4], acc[0][5]);
        o.w = pack_bf16x2(acc[0][6], acc[0][7]);
        *reinterpret_cast<uint4*>(y + y_off) = o;
      }
      y_off += step;
    }
#pragma unroll
    for (int q = 0; q < K - 1; ++q)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[q][e] = acc[q + 1][e];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[K - 1][e] = bv;
#pragma unroll
    for (int v = 0; v < G::NV; ++v)
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) cur[v][wi] = nxt[v][wi];
  }
}

template <int K, int D>
int launch(const void* x, const void* w, const void* bias, void* y, int N,
           int H, int W, int C, long long w_tap, long long w_ch, int segs,
           int seg_rows, cudaStream_t stream) {
  const int strips = (W + STRIP - 1) / STRIP;
  const long long tasks = static_cast<long long>(N) * segs * D * strips * C;
  const long long blocks = (tasks + WARPS - 1) / WARPS;
  if (blocks * WARPS >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  dw_chw_kernel<K, D><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), N, H, W, C, w_tap,
      w_ch, strips, segs, seg_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int K, typename... A>
int dispatch_d(int d, A... a) {
  if (d == 1) return launch<K, 1>(a...);
  if (d == 2) return launch<K, 2>(a...);
  if (d == 3) return launch<K, 3>(a...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: contiguous bf16 [N, H, C, W], W a multiple of 8, x and y 16-byte
// aligned; w: tap t of channel c at w[t * w_tap + c * w_ch]; bias: [C] or
// null; k in {3, 5, 7}, d in {1, 2, 3}. Output rows of each class mod d are
// cut into `segs` segments of `seg_rows` (ops/dwconv.py:dw_plan). y must not
// alias x. Launches on `stream`; returns cudaGetLastError() (0 = success).
extern "C" int rs_dw_conv_chw(const void* x, const void* w, const void* bias,
                              void* y, int N, int H, int W, int C, int k,
                              int d, long long w_tap, long long w_ch, int segs,
                              int seg_rows, void* stream) {
  if (N < 1 || H < 1 || W < 8 || W % 8 || C < 1 || segs < 1 || seg_rows < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3)
    return dispatch_d<3>(d, x, w, bias, y, N, H, W, C, w_tap, w_ch, segs,
                         seg_rows, st);
  if (k == 5)
    return dispatch_d<5>(d, x, w, bias, y, N, H, W, C, w_tap, w_ch, segs,
                         seg_rows, st);
  if (k == 7)
    return dispatch_d<7>(d, x, w, bias, y, N, H, W, C, w_tap, w_ch, segs,
                         seg_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
