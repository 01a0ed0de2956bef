// What the wgmma kernels share beside the products themselves (wgmma.cuh):
// mbarriers and bulk copies for the weight pipeline, bf16 pairs in 32-bit
// words, and the branch-free erf GELU.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rs {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival that also announces `bytes` of copies to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// waits until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
// asynchronous copy of `bytes` (a multiple of 16) contiguous bytes from
// global to shared memory; completion is counted on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// erf GELU without a branch: erf by Abramowitz and Stegun 7.1.26 (absolute
// error 1.5e-7, far below the bf16 rounding that follows), written so that
// the negative tail keeps its relative accuracy: with q = erfc(|v| / sqrt 2),
// gelu(v) = v q / 2 for v < 0 and v (2 - q) / 2 otherwise. sixteen of these
// interleave in a thread where erff's branches would run one after another.
__device__ __forceinline__ float gelu_erf_as(float v) {
  const float z = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.f, fmaf(0.3275911f, z, 1.f));
  float p = fmaf(1.061405429f, t, -1.453152027f);
  p = fmaf(p, t, 1.421413741f);
  p = fmaf(p, t, -0.284496736f);
  p = fmaf(p, t, 0.254829592f);
  const float q = p * t * __expf(-z * z);
  return 0.5f * v * (v < 0.f ? q : 2.f - q);
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace rs
