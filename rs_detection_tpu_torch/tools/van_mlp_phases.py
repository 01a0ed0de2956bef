"""Where the wgmma designs of the VAN MLP kernel spend their time: build
copies of ``csrc/van_mlp_wgmma.cu`` (K2, bf16) and
``csrc/van_mlp_int8_wgmma.cu`` (K2q, the int8 form) with one phase cut
out each and time them beside the whole kernel at the VAN-b3 stage
shapes (batch 8, bf16) on one CUDA GPU. ``ncu`` is not always to be had;
a phase that can be removed without a hang can still be weighed this way.

Run from the repository root:
``python3 -m rs_detection_tpu_torch.tools.van_mlp_phases`` (both
kernels; ``K2`` or ``K2q`` as an argument for one). Each variant
is the source with a few lines replaced (a missing pattern raises: the
tables below follow the kernels), compiled on its own by ``nvcc`` with
``-Xptxas -v`` into a scratch directory and loaded with ctypes. It prints
per variant ptxas' registers, spill lines and C7514 notes (``wgmma
serialized``), then one line of ms per launch for each shape. A variant's
output is wrong by construction; only its time means something. ptxas
drops a wgmma whose sums nobody reads, so ``no finish`` also removes
fc1: read fc1's share from ``no fc1``.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import _build

SHAPES = [(8, 256, 64, 512), (8, 128, 128, 1024), (8, 64, 320, 1280),
          (8, 32, 512, 2048)]  # (N, H = W, C, Ch)
_GELU = ("pack_bf16(gelu_erf_as(a[q][0] + bd0),\n"
         "                        gelu_erf_as(a[q][1] + bd1))",
         "pack_bf16(a[q][0] + bd0, a[q][1] + bd1)")
_DW = ("for (int dy = 0; dy < 3; ++dy) {", "for (int dy = 0; dy < 0; ++dy) {")
_FC1 = ("      start_fc1((k + 1) & 1);\n", "")
_FC2 = ("wgmma_ss<N2>(yacc, da + 2 * ks, db + 2 * ks, (k | ks) != 0);", "")
_FINISH = ("      finish_h1((k + 1) % VS_SLOTS);\n", "")
_QUARTER = [
    ("mbar_expect_tx(bar, P.w2);",
     "mbar_expect_tx(bar, P.vs / 4 + VS_BYTES);"),
    ("bulk_copy(w1s + (kc & 1) * (KB * W1_KB), src, P.vs, bar);",
     "bulk_copy(w1s + (kc & 1) * (KB * W1_KB), src, P.vs / 4, bar);"),
    ("mbar_expect_tx(bar, W2_BYTES);", "mbar_expect_tx(bar, W2_BYTES / 4);"),
    ("bulk_copy(w2s + (kc % W2B) * W2_BYTES, src + P.w2, W2_BYTES, bar);",
     "bulk_copy(w2s + (kc % W2B) * W2_BYTES, src + P.w2, W2_BYTES / 4, "
     "bar);")]
VARIANTS = {
    "whole": [],
    "no gelu": [_GELU],
    "no dw, no gelu": [_GELU, _DW],
    "no fc1": [_FC1],
    "no fc2": [_FC2],
    "no finish (nor fc1)": [_FINISH],
    "a quarter of the weight bytes": _QUARTER,
    "copies and barriers only": [_GELU, _DW, _FC1, _FC2, _FINISH],
}
# the int8 form: the same phases, and the two it adds (the chunk maxima with
# their block barrier, the dequantizing add of every fc2 product)
_Q_GELU = [("a[q][0] = in ? gelu_erf_as(a[q][0] + bd0) : 0.f;",
            "a[q][0] = in ? a[q][0] + bd0 : 0.f;"),
           ("a[q][1] = in ? gelu_erf_as(a[q][1] + bd1) : 0.f;",
            "a[q][1] = in ? a[q][1] + bd1 : 0.f;")]
_Q_MAX = ("      __syncthreads();\n#pragma unroll\n"
          "      for (int c = 0; c < NQ; ++c) {",
          "#pragma unroll\n      for (int c = 0; c < NQ; ++c) {")
_Q_ADD = ("        acc = __fadd_rn(acc, __fmul_rn(s, static_cast<float>("
          "part[t & 1][i])));\n", "        acc += s;\n")
Q_VARIANTS = {
    "whole": [],
    "no gelu": _Q_GELU,
    "no dw, no gelu": _Q_GELU + [_DW],
    "no fc1": [_FC1],
    "no fc2 (products and adds)": [_Q_ADD],
    "no barrier for the chunk maxima": [_Q_MAX],
    "no finish (nor fc1)": [_FINISH],
    "copies and barriers only": _Q_GELU + [_DW, _FC1, _Q_ADD, _FINISH],
}
_EXPORT = '''
extern "C" int run(const void* x, const void* w1, const void* b1,
                   const void* wdw, const void* bdw, const void* w2,
                   const void* b2, void* y, void* scratch, int N, int H,
                   int W, int C, int Ch, void* stream) {
  return rs::%s(x, w1, b1, wdw, bdw, w2, b2, y, scratch, N, H, W, C, Ch, 0,
                static_cast<cudaStream_t>(stream));
}
'''
# kernel: (source, its launcher, the name of its __global__, variants)
KERNELS = {
    "K2": ("van_mlp_wgmma.cu", "van_mlp_wgmma_launch",
           "van_mlp_wgmma_kernel", VARIANTS),
    "K2q": ("van_mlp_int8_wgmma.cu", "van_mlp_q_wgmma_launch",
            "van_mlp_q_wgmma_kernel", Q_VARIANTS),
}


def _variant(file, source, edits, launcher):
    for old, new in edits:
        if old not in source:
            raise ValueError(f"{file} no longer has {old!r}")
        source = source.replace(old, new)
    return source + _EXPORT % launcher


def build(workdir, kernel="K2"):
    """Compile every variant of ``kernel`` (all nvcc started together);
    returns {name: library path} and prints what ptxas said of each."""
    file, launcher, entry_name, variants = KERNELS[kernel]
    source = (_build.CSRC / file).read_text()
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        d = Path(workdir) / f"{kernel}_v{i}"
        shutil.copytree(_build.CSRC, d)
        (d / file).write_text(_variant(file, source, edits, launcher))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-o", str(d / "lib.so"), str(d / file)]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{out}")
        regs, entry = [], ""
        for ln in out.splitlines():  # the MLP kernels, not the repack's
            if "Compiling entry function" in ln:
                entry = ln
            elif "Used" in ln and entry_name in entry:
                width = re.search(r"kernelILi(\d+)E", entry)
                regs.append(f"C={width.group(1) if width else '?'}: "
                            + ln.split("Used ")[1].split(" ")[0])
        spills = sum("spill" in ln and " 0 bytes spill stores" not in ln
                     for ln in out.splitlines())
        print(f"{kernel} {name}: registers {', '.join(regs)}; {spills} "
              f"kernels spill, "
              f"C7514 notes "
              f"{out.count('C7514')}", flush=True)
        libs[name] = lib
    return libs


def cuda_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("van_mlp_phases: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = torch.Generator(device=dev).manual_seed(1)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale) \
            .to(torch.bfloat16)

    for kernel in sys.argv[1:] or list(KERNELS):
        time_variants(kernel, r, dev)


def time_variants(kernel, r, dev):
    with tempfile.TemporaryDirectory() as workdir:
        libs = {name: ctypes.CDLL(str(path))
                for name, path in build(workdir, kernel).items()}
        for lib in libs.values():
            lib.run.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            lib.run.restype = ctypes.c_int
        scratch = torch.empty(8 << 20, dtype=torch.uint8, device=dev)
        for n, h, c, ch in SHAPES:
            args = (r(n, h, h, c), r(ch, c, scale=c ** -0.5),
                    r(ch, scale=0.1), r(ch, 9, scale=1 / 3), r(ch, scale=0.1),
                    r(c, ch, scale=ch ** -0.5), r(c, scale=0.1))
            y = torch.empty_like(args[0])
            stream = torch.cuda.current_stream().cuda_stream
            times = []
            for name, lib in libs.items():
                def launch(lib=lib):
                    err = lib.run(*(t.data_ptr() for t in args), y.data_ptr(),
                                  scratch.data_ptr(), n, h, h, c, ch, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                times.append(f"{name} {cuda_ms(launch):.3f}")
            print(f"{kernel} [{n},{h},{h},{c}] Ch={ch}, ms per launch: "
                  + " | ".join(times), flush=True)


if __name__ == "__main__":
    main()
