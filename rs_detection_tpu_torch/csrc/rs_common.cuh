// Helpers shared by the port's CUDA sources: dtype conversion, the erf GELU,
// and cp.async staging of 16-byte vectors into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace rs {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back: the storage points of the TPU kernels
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__host__ __device__ inline size_t up128(size_t v) {
  return (v + 127) & ~static_cast<size_t>(127);
}

// One 16-byte cp.async from global memory to the shared address `dst` (or
// the shared-memory pointer `dst`); src == nullptr zero-fills (the address
// must still be valid: pass any in `any_valid`). Lands after a
// cp_async_wait<N>() that covers its committed group and a barrier.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           const void* any_valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src ? src : any_valid), "r"(src ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           const void* any_valid) {
  cp_async16(static_cast<unsigned>(__cvta_generic_to_shared(dst)), src,
             any_valid);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most `Pending` of this thread's committed groups are in flight
template <int Pending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Starts copies of `count` 16-byte vectors from global to shared memory,
// vector i from src(i) to dst(i); src(i) == nullptr zero-fills. cp.async
// keeps all of a thread's copies in flight with no register round trip;
// they land after cp_async_wait_all() and a __syncthreads(). Every thread
// of the block calls it.
template <typename Src, typename Dst>
__device__ __forceinline__ void copy_vec16(int count, const void* any_valid,
                                           Src src, Dst dst) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    cp_async16(dst(i), src(i), any_valid);
  cp_async_commit();
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// The largest dynamic shared memory one block may ask for on this device.
inline int smem_optin_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

}  // namespace rs
