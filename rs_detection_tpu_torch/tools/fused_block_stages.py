"""Time the stages of the fused VAN attention half-block (K4) and the
depthwise forward kernel (K5) with 1 and 4 outputs per thread, at the
VAN-b3 shapes of a batch of 8 1024^2 tiles in bf16, on one CUDA GPU.

Run from the repository root:
``python3 -m rs_detection_tpu_torch.tools.fused_block_stages``. It
builds the kernels, prints the card's name and power limit, what ptxas
says of the wgmma design of ``proj1`` and ``tail``
(``csrc/van_attn_wgmma.cu``: registers, spills, C7514 notes), then one
line per shape with CUDA-event times in ms, ``proj1`` and ``tail``
beside their byte floors (x in and g out; x, g, d7 in and out out, at
3.35 TB/s) and beside the first design's times. The stages are launched
through the library's C interface, so the rows-per-thread form that the
wrapper does not pick can be timed too.
"""

from __future__ import annotations

import re
import subprocess
import tempfile

import torch

from ..ops import _build
from ..ops._build import kernel_library

STAGES = [(256, 64, 3), (128, 128, 5), (64, 320, 27), (32, 512, 3)]
BATCH = 8
BF16 = 1  # dtype code of the C interface
PEAK_BYTES = 3.35e12  # HBM bytes/s of one H100 SXM
# ms per launch of the first design (WMMA, 64 pixels per block) of proj1 and
# tail at STAGES: this tool on the tree before the wgmma design, NVIDIA H100
# 80GB HBM3 at 700 W
FIRST_DESIGN_MS = {"proj1": [0.255, 0.148, 0.173, 0.103],
                   "tail": [0.374, 0.226, 0.271, 0.198]}


def ptxas_report(source):
    """Compile one ``csrc/`` source with ``-Xptxas -v`` and print each
    kernel's registers, the spill lines and the count of C7514 notes
    (``wgmma serialized``)."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
               "-o", f"{d}/out.o", str(_build.CSRC / source)]
        out = subprocess.run(cmd, capture_output=True, text=True)
    text = out.stdout + out.stderr
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{text}")
    found, entry, spilled = [], "", ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(attn_[a-z0-9]+)_wgmma_kernelILi(\d+)E", ln)
            entry = f"{m.group(1)}<{m.group(2)}>" if m else ln.split("'")[1]
            spilled = ""
        elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
            spilled = ", " + ln.strip().split(", ", 1)[1]
        elif "Used" in ln and "pack" not in entry:
            regs = ln.split("Used ")[1].split(" ")[0]
            found.append(f"{entry} {regs} registers{spilled}")
    print(f"{source}: C7514 notes {text.count('C7514')}; "
          + "; ".join(found), flush=True)


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
        raise SystemExit("fused_block_stages: needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    ptxas_report("van_attn_wgmma.cu")
    lib = kernel_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def r(*s, scale=1.0, dt=torch.bfloat16):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dt)

    def check(err):
        if err != 0:
            raise RuntimeError(f"kernel launch failed: CUDA error {err}")

    def dw(x, y, w, b, k, d, rows):
        n, h, width, c = x.shape
        check(lib.rs_dw_conv_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                 y.data_ptr(), n, h, width, c, k, d, 1, k * k,
                                 rows, BF16, 0, stream))

    totals = dict.fromkeys(("proj1", "dw5", "dw7d3", "tail"), 0.0)
    floors = dict.fromkeys(("proj1", "tail"), 0.0)
    for stage, (h, c, blocks) in enumerate(STAGES):
        x = r(BATCH, h, h, c, scale=0.5)
        a1, b1 = 1 + r(c, scale=0.1, dt=torch.float32), \
            r(c, scale=0.1, dt=torch.float32)
        wp1, wc1, wp2 = (r(c, c, scale=c ** -0.5) for _ in range(3))
        bp1, b0, bs, bc1, bp2, ls1 = (r(c, scale=0.1) for _ in range(6))
        w0, ws = r(c, 25, scale=0.2), r(c, 49, scale=1 / 7)
        g, d5, d7, out = (torch.empty_like(x) for _ in range(4))
        pixels = x.numel() // c
        scratch = torch.empty(lib.rs_van_attn_scratch_bytes(c, BF16),
                              dtype=torch.uint8, device=dev)
        ms = {
            "proj1": cuda_ms(lambda: check(lib.rs_van_attn_proj1(
                x.data_ptr(), a1.data_ptr(), b1.data_ptr(), wp1.data_ptr(),
                bp1.data_ptr(), g.data_ptr(), scratch.data_ptr(), pixels, c,
                BF16, stream))),
            "dw5": cuda_ms(lambda: dw(g, d5, w0, b0, 5, 1, 4)),
            "dw7d3": cuda_ms(lambda: dw(d5, d7, ws, bs, 7, 3, 4)),
            "tail": cuda_ms(lambda: check(lib.rs_van_attn_tail(
                x.data_ptr(), a1.data_ptr(), b1.data_ptr(), g.data_ptr(),
                d7.data_ptr(), wc1.data_ptr(), bc1.data_ptr(), wp2.data_ptr(),
                bp2.data_ptr(), ls1.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), pixels, c, BF16, stream))),
        }
        one = {"dw5": cuda_ms(lambda: dw(g, d5, w0, b0, 5, 1, 1)),
               "dw7d3": cuda_ms(lambda: dw(d5, d7, ws, bs, 7, 3, 1))}
        for k, v in ms.items():
            totals[k] += blocks * v
        floor = {"proj1": 2e3 * x.numel() * 2 / PEAK_BYTES,
                 "tail": 4e3 * x.numel() * 2 / PEAK_BYTES}
        for k, v in floor.items():
            floors[k] += blocks * v

        def show(k):
            extra = (f" (byte floor {floor[k]:.3f}, first design "
                     f"{FIRST_DESIGN_MS[k][stage]:.3f})" if k in floor else "")
            return f"{k} {ms[k]:.3f}{extra}"

        print(f"K4 [{BATCH},{h},{h},{c}] x{blocks}: "
              + ", ".join(show(k) for k in ms)
              + f"; with 1 output per thread dw5 {one['dw5']:.3f}, dw7d3 "
                f"{one['dw7d3']:.3f}", flush=True)
    first = {k: sum(b * t for (_, _, b), t in zip(STAGES, v))
             for k, v in FIRST_DESIGN_MS.items()}
    print("K4 per forward: " + ", ".join(
        f"{k} {v:.3f}" + (f" (byte floor {floors[k]:.3f}, first design "
                          f"{first[k]:.3f})" if k in floors else "")
        for k, v in totals.items())
        + f", sum {sum(totals.values()):.3f} ms")
    # dw3 on the MLP hidden tensors: the shapes where 1 output per thread
    # is the wrapper's choice
    for h, ch in ((256, 512), (128, 1024), (64, 1280), (32, 2048)):
        x, y = r(BATCH, h, h, ch), torch.empty(BATCH, h, h, ch,
                                               dtype=torch.bfloat16,
                                               device=dev)
        w, b = r(ch, 9, scale=1 / 3), r(ch, scale=0.1)
        print(f"K5 k3d1 [{BATCH},{h},{h},{ch}]: 1 output per thread "
              f"{cuda_ms(lambda: dw(x, y, w, b, 3, 1, 1)):.3f}, 4 "
              f"{cuda_ms(lambda: dw(x, y, w, b, 3, 1, 4)):.3f}", flush=True)


if __name__ == "__main__":
    main()
