"""Write ``rs_detection_tpu_torch/csrc/wgmma.cuh``: the descriptors, fences
and one ``wgmma_ss<N>`` specialization per tile width in ``WIDTHS`` (bf16
x bf16 -> f32, depth 16) and one ``wgmma_ss_s8<N>`` per width in
``S8_WIDTHS`` (s8 x s8 -> s32, depth 32). Their inline PTX differs only
in its register list, N / 2 of them, which nobody should type by hand.
The integer form has no ``imm-scale`` and no transpose operands: its
operand list ends after ``scale-d``, and both operands must be K-major.
Run from the repository root after changing the widths or the text:
``python3 -m rs_detection_tpu_torch.tools.gen_wgmma_header``. The header
is committed; nothing runs this at build time."""

import textwrap
from pathlib import Path

WIDTHS = (32, 64, 128, 160, 256)
S8_WIDTHS = (32, 64, 80)
OUT = Path(__file__).resolve().parents[1] / "csrc" / "wgmma.cuh"

def _lists(n, constraint):
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    reglist = textwrap.fill(regs, 70)
    reglist = "\n".join(f'      "{l} "' for l in reglist.splitlines())
    ops = ", ".join(f'"+{constraint}"(d[{i}])' for i in range(r))
    ops = textwrap.fill(ops, 72, initial_indent="      : ", subsequent_indent="        ")
    return r, reglist, ops


def gen_s8(n):
    r, reglist, ops = _lists(n, "r")
    return f'''template <>
__device__ __forceinline__ void wgmma_ss_s8<{n}>(int (&d)[{r}], uint64_t a,
                                                 uint64_t b, int accumulate) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r+2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 {{"
{reglist}
      "}}, %{r}, %{r+1}, p;\\n}}\\n"
{ops}
      : "l"(a), "l"(b), "r"(accumulate));
}}
'''


def gen(n):
    r, reglist, ops = _lists(n, "f")
    return f'''template <>
__device__ __forceinline__ void wgmma_ss<{n}>(float (&d)[{r}], uint64_t a,
                                              uint64_t b, int accumulate) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r+2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 {{"
{reglist}
      "}}, %{r}, %{r+1}, p, 1, 1, 0, 0;\\n}}\\n"
{ops}
      : "l"(a), "l"(b), "r"(accumulate));
}}
'''
head = '''// wgmma for Hopper (sm_90a): descriptors, fences and the warpgroup products
// bf16 x bf16 -> f32 (`wgmma_ss<N>`, depth 16) and s8 x s8 -> s32
// (`wgmma_ss_s8<N>`, depth 32) with both operands in shared memory.
//
// Both operands are K-major tiles in the 128-byte swizzled layout: a row (an
// M index of A, an N index of B) holds 64 bf16 of K in 128 bytes, eight rows
// make a 1024-byte atom (1024-byte aligned), and the 16-byte vector j of row
// r sits at vector j ^ (r % 8). Row groups follow each other 1024 bytes
// apart (the descriptor's stride offset); a step of 16 along K inside the
// atom adds 32 bytes to the start address. `wgmma_ss<N>` is one
// m64nNk16 product: D[64, N] (+)= A[64, 16] * B[N, 16]^T, D spread over
// the 128 threads of the warpgroup (thread t of warp w holds rows 16 w + t / 4
// and + 8, columns 8 j + 2 (t % 4) + {0, 1} in d[4 j + {0, 1}] and
// d[4 j + {2, 3}]). `wgmma_ss_s8<N>` is one m64nNk32 product of s8 tiles in
// the same layouts (a row of 128 bytes holds 128 values of K, a k-step is
// again 32 bytes) with the s32 sums in the same slots; it has no transposed
// form. The N forms differ only in their register lists; the file is written
// by tools/gen_wgmma_header.py, edit that.

#pragma once

#include <stdint.h>

namespace rs {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// descriptor of a 128-byte swizzled K-major tile at shared address `addr`
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// the same for the 64-byte swizzled layout of a tile 32 bf16 deep: rows of 64
// bytes, eight rows a 512-byte atom, vector j of row r at j ^ ((r / 2) % 4)
__device__ __forceinline__ uint64_t wgmma_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}

// the same for the 32-byte swizzled layout of a tile 32 bytes deep (one k-step:
// 32 s8 or 16 bf16): rows of 32 bytes, eight rows a 256-byte atom, vector j
// (0 or 1) of row r at j ^ ((r / 4) % 2)
__device__ __forceinline__ uint64_t wgmma_desc32(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         (16ull << 32) | (3ull << 62);
}

// byte offset of element (row, col) of a [rows, 64] bf16 swizzled tile
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// orders earlier register and shared-memory accesses before the next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}
// waits until at most `Pending` committed groups are still running
template <int Pending> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(Pending) : "memory");
}
// makes this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}

// Pins accumulator registers at this point of the program: put it after the
// wait that completes their wgmma, or the compiler may move a read of them
// above that wait (ptxas then serializes every wgmma, note C7514).
template <int R> __device__ __forceinline__ void wgmma_pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R> __device__ __forceinline__ void wgmma_pin(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_ss_s8(int (&d)[N / 2], uint64_t a,
                                            uint64_t b, int accumulate);

'''


def main():
    body = "\n".join([gen(n) for n in WIDTHS]
                     + [gen_s8(n) for n in S8_WIDTHS])
    OUT.write_text(head + body + "\n}  // namespace rs\n")


if __name__ == "__main__":
    main()
