// Clocks per wgmma m64nNk16 (bf16, both operands in 128-byte swizzled shared
// memory) for N = 32 .. 256, with one and with two warpgroups on an SM: what
// a tile width costs before any kernel is built around it. Each
// warpgroup runs 200 rounds of 20 wgmma that add into one accumulator tile,
// commits, waits, and reads clock64() around it all.
//
// Build and run on a Hopper card, from the repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o build/wgmma_bench rs_detection_tpu_torch/tools/wgmma_bench.cu
//   build/wgmma_bench
// At peak an SM's tensor cores take N / 2 clocks for one of them.

#include <cstdio>

#include <cuda_runtime.h>

#include "../csrc/wgmma.cuh"

using namespace rs;

constexpr int STEPS = 20, ROUNDS = 200;

template <int N>
__global__ void __launch_bounds__(256, 1) bench(long long* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sm = (smem_u32(smem) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  // A: 64 rows per warpgroup; B: N rows, shared; five 64-deep blocks each
  const uint64_t da = wgmma_desc(sm + wg * 8192);
  const uint64_t db = wgmma_desc(sm + 32768);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < ROUNDS; ++it) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      wgmma_ss<N>(d, da + ((s / 4) * 1024 + (s % 4) * 2),
                  db + ((s / 4) * 2048 + (s % 4) * 2), 1);
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_pin(d);
  }
  const long long t1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum += d[i];
  if (threadIdx.x % 128 == 0) out[blockIdx.x * 2 + wg] = t1 - t0;
  if (sum == 12345.f) out[0] = 0;  // keeps the sums alive
}

template <int N> void run(int warpgroups) {
  long long* out;
  cudaMalloc(&out, 512 * sizeof(long long));
  cudaFuncSetAttribute(bench<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       200 * 1024);
  bench<N><<<132, 128 * warpgroups, 200 * 1024>>>(out);
  cudaDeviceSynchronize();
  long long clocks = 0;
  cudaMemcpy(&clocks, out, sizeof(clocks), cudaMemcpyDeviceToHost);
  printf("m64n%dk16, %d warpgroup(s): %.1f clocks per wgmma of a warpgroup "
         "(CUDA error %d)\n", N, warpgroups,
         clocks / static_cast<double>(ROUNDS * STEPS),
         static_cast<int>(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  for (int warpgroups = 1; warpgroups <= 2; ++warpgroups) {
    run<32>(warpgroups);
    run<64>(warpgroups);
    run<128>(warpgroups);
    run<160>(warpgroups);
    run<256>(warpgroups);
  }
  return 0;
}
