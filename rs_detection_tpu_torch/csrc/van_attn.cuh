// What the two sources of the fused VAN attention half-block share:
// van_attn.cu (what the stages compute, the launcher, the first design) and
// van_attn_wgmma.cu (the wgmma design of `proj1` and `tail` in bf16).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rs {

// True where the wgmma design takes a bf16 half-block of this width: C in
// {64, 128, 256, 320, 512}. Every other shape runs the first design.
bool van_attn_wgmma_takes(int C);

// Bytes of dynamic shared memory one block of `proj1` (tail = 0) or `tail`
// asks for.
size_t van_attn_wgmma_smem_bytes(int C, int tail);

// Bytes of device scratch the two stages share: wp1, wc1 and wp2 repacked
// into slabs of swizzled B tiles, in that order.
size_t van_attn_wgmma_scratch_bytes(int C);

// Launch a stage on `stream` (pointers and layouts as rs_van_attn_proj1 /
// rs_van_attn_tail, bf16): a kernel that repacks the stage's weights into its
// part of `scratch`, then the stage. Return cudaGetLastError().
int van_attn_wgmma_proj1(const void* x, const void* a1, const void* b1,
                         const void* wp1, const void* bp1, void* g,
                         void* scratch, long long P, int C,
                         cudaStream_t stream);
int van_attn_wgmma_tail(const void* x, const void* a1, const void* b1,
                        const void* g, const void* d7, const void* wc1,
                        const void* bc1, const void* wp2, const void* bp2,
                        const void* ls1, void* out, void* scratch, long long P,
                        int C, cudaStream_t stream);

}  // namespace rs
