// What the sources of the fused VAN MLP share: van_mlp.cu (the launcher and
// the WMMA / FMA kernel) with van_mlp_wgmma.cu (the wgmma design of the bf16
// kernel), and van_mlp_int8.cu (the int8 form: launcher, first design) with
// van_mlp_int8_wgmma.cu (its wgmma design).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rs {

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
// first design (WMMA s8 in bf16, integer multiply-adds in f32).
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
