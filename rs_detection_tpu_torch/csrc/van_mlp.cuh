// What the sources of the fused VAN MLP share: van_mlp.cu (the launcher and
// the WMMA kernel) with van_mlp_wgmma.cu (the wgmma design of the bf16
// kernel) and van_mlp_f32.cu (the f32 design), and van_mlp_int8.cu (the int8
// form: launcher, first design, f32 design) with van_mlp_int8_wgmma.cu (its
// wgmma design).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <initializer_list>

namespace rs {

// The f32 designs of both forms keep a block's fc2 sums in registers: a
// thread holds 8 output pixels x J output channels, a block 32 J channels (J
// <= 16), and a C wider than 512 is split over gridDim.z into as few equal
// parts as that allows. J is the smallest instantiated count that covers a
// part.
inline int van_mlp_f32_slots(int C) {
  const int parts = (C + 511) / 512;
  const int need = ((C + parts - 1) / parts + 31) / 32;
  for (int j : {1, 2, 4, 5, 8, 10, 16})
    if (j >= need) return j;
  return 16;
}
// blocks over the output channels (gridDim.z)
inline int van_mlp_f32_splits(int C) {
  const int per = 32 * van_mlp_f32_slots(C);
  return (C + per - 1) / per;
}

// The f32 design of the float form (van_mlp_f32.cu): bytes of dynamic shared
// memory one block asks for (69,632 + 9,216 J), and its launch (all pointers
// f32, layouts as rs_van_mlp_fwd; no scratch). Returns cudaGetLastError().
size_t van_mlp_f32_smem_bytes(int C);
int van_mlp_f32_launch(const void* x, const void* w1, const void* b1,
                       const void* wdw, const void* bdw, const void* w2,
                       const void* b2, void* y, int N, int H, int W, int C,
                       int Ch, int residual, cudaStream_t stream);

// True where the wgmma design takes a bf16 MLP of these widths: C in {64,
// 128, 256, 320} and Ch a multiple of 8 (its weight chunks are copied in
// 16-byte vectors). Every other shape runs the WMMA kernel.
bool van_mlp_wgmma_takes(int C, int Ch);

// Bytes of dynamic shared memory one block of the wgmma design asks for.
size_t van_mlp_wgmma_smem_bytes(int C);

// Bytes of device scratch a launch of the wgmma design needs: the weights
// repacked per 64-channel hidden chunk into the kernel's shared-memory layout.
size_t van_mlp_wgmma_scratch_bytes(int C, int Ch);

// Launches the wgmma design on `stream` (all pointers bf16, layouts as
// rs_van_mlp_fwd; `scratch` 16-byte aligned): a kernel that repacks the
// weights into `scratch`, then the MLP. Returns cudaGetLastError().
int van_mlp_wgmma_launch(const void* x, const void* w1, const void* b1,
                         const void* wdw, const void* bdw, const void* w2,
                         const void* b2, void* y, void* scratch, int N, int H,
                         int W, int C, int Ch, int residual,
                         cudaStream_t stream);

// The int8 form. True where its wgmma design takes a bf16 MLP of these
// widths: C in {64, 128, 256, 320, 512}, any Ch. Every other shape runs the
// first design (WMMA s8 in bf16, C in {32, 160}) or the f32 design (dp4a).
bool van_mlp_q_wgmma_takes(int C, int Ch);
size_t van_mlp_q_wgmma_smem_bytes(int C);
// Bytes of device scratch: the weights quantized per output channel and
// packed per round of hidden channels into the kernel's shared-memory layout,
// with b1, bdw, the taps and the scales.
size_t van_mlp_q_wgmma_scratch_bytes(int C, int Ch);
// The weight preparation alone (float weights in, packed bytes in `scratch`).
int van_mlp_q_wgmma_pack(const void* w1, const void* b1, const void* wdw,
                         const void* bdw, const void* w2, void* scratch, int C,
                         int Ch, cudaStream_t stream);
// The weight preparation, then the MLP (all pointers bf16, float weights).
int van_mlp_q_wgmma_launch(const void* x, const void* w1, const void* b1,
                           const void* wdw, const void* bdw, const void* w2,
                           const void* b2, void* y, void* scratch, int N,
                           int H, int W, int C, int Ch, int residual,
                           cudaStream_t stream);

}  // namespace rs
