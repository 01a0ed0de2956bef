"""Where the streaming design of the depthwise forward (K5,
``csrc/dw_conv_fwd_stream.cu``) spends its time: build copies of the
source with a phase cut out or the ring's depth changed, and time them
beside the whole kernel at the eight attention shapes of VAN-b3 (batch 8,
bf16, the fused block's ``[C, k*k]`` taps and bias) on one CUDA GPU.

Run from the repository root:
``python3 -m rs_detection_tpu_torch.tools.dw_stream_phases``. Each
variant is the source with a few lines replaced (a missing pattern
raises), compiled on its own by ``nvcc`` with ``-Xptxas -v`` into a
scratch directory and loaded with ctypes; the launch takes the plan of
``ops/dwconv.py:dw_plan``. It prints per variant ptxas' registers and
spill lines, the whole kernel's SASS instructions by opcode
(``cuobjdump -sass``; every loop is unrolled, so these are the
instructions of one step plus the set-up), then one line of ms per
launch for each shape, with the whole kernel also at one segment and at
one step per segment. A variant's output is wrong by construction; only
its time means something.
"""

from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import _build
from ..ops import dwconv as dw

FILE = "dw_conv_fwd_stream.cu"
SHAPES = [(k, d, h, c) for k, d in ((5, 1), (7, 3))
          for h, c in ((256, 64), (128, 128), (64, 320), (32, 512))]
BATCH = 8
_STAGES = "constexpr int STAGES = 3;"
VARIANTS = {
    "whole": [],
    "2 stages": [(_STAGES, "constexpr int STAGES = 2;")],
    "4 stages": [(_STAGES, "constexpr int STAGES = 4;")],
    "no loads": [("          cp_async16(dst",
                  "          if (false) cp_async16(dst")],
    "one tap per value": [
        ("acc[i][j][0] = fmaf(v.x, wr[ky * K + kx][0], acc[i][j][0]);",
         "if (i == 0 && j == 0) acc[0][0][0] += v.x;"),
        ("acc[i][j][1] = fmaf(v.y, wr[ky * K + kx][1], acc[i][j][1]);",
         "if (i == 0 && j == 0) acc[0][0][1] += v.y;")],
    "no stores": [("    if (ch < C) {\n",
                   "    if (ch < C && acc[0][0][0] == 1234.5f) {\n")],
}


def build(workdir):
    """Compile every variant (all nvcc started together); returns {name:
    loaded library} and prints what ptxas said of each."""
    source = (_build.CSRC / FILE).read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = source
        for old, new in edits:
            if old not in text:
                raise ValueError(f"{FILE} no longer has {old!r}")
            text = text.replace(old, new)
        d = Path(workdir) / f"v{i}"
        shutil.copytree(_build.CSRC, d)
        (d / FILE).write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-o", str(d / "lib.so"), str(d / FILE)]
        procs[name] = (d / "lib.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{out}")
        regs = [ln.split("Used ")[1].split(" ")[0] for ln in out.splitlines()
                if "Used" in ln]
        spills = [ln.strip() for ln in out.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"{name}: registers {', '.join(regs)}; spills {spills}",
              flush=True)
        lib = ctypes.CDLL(str(path))
        fn = lib.rs_dw_conv_fwd_stream
        fn.argtypes, fn.restype = _build.SIGNATURES["rs_dw_conv_fwd_stream"]
        libs[name] = fn
    for kernel, counts in sass_counts(procs["whole"][0]).items():
        print(f"whole, {kernel}: {sum(counts.values())} SASS instructions: "
              + ", ".join(f"{op} {n}" for op, n in counts.most_common(12)),
              flush=True)
    return libs


def sass_counts(lib_path):
    """SASS instructions by opcode of each kernel in ``lib_path``."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = re.sub(r".*dw_stream_kernelILi(\d)ELi(\d)ELi(\d+)E.*",
                          r"K\1 d\2 G\3", m.group(1))
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     ln)
        if m and name:
            counts[name][m.group(1).split(".")[0]] += 1
    return counts


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
        raise SystemExit("dw_stream_phases: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as workdir:
        libs = build(workdir)
        for k, d, h, c in SHAPES:
            x = torch.randn(BATCH, h, h, c, generator=g, device=dev) \
                .to(torch.bfloat16)
            w = (torch.randn(c, k * k, generator=g, device=dev) / k) \
                .to(torch.bfloat16)
            b = (torch.randn(c, generator=g, device=dev) * 0.1) \
                .to(torch.bfloat16)
            y = torch.empty_like(x)
            plan = dw.dw_plan(k, d, h, h, c, torch.bfloat16, n=BATCH)
            steps = plan["segs"] * plan["seg_steps"]
            runs = [(name, fn, plan["segs"], plan["seg_steps"])
                    for name, fn in libs.items()]
            runs += [("whole, one segment", libs["whole"], 1, steps),
                     ("whole, one step per segment", libs["whole"], steps, 1)]
            times = []
            for name, fn, segs, per in runs:
                def launch(fn=fn, name=name, segs=segs, per=per):
                    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             y.data_ptr(), BATCH, h, h, c, k, d, 1, k * k,
                             plan["groups"], segs, per, stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                times.append(f"{name} {cuda_ms(launch):.4f}")
            print(f"k{k}d{d} [{BATCH},{h},{h},{c}] (plan: {plan}): "
                  + "; ".join(times), flush=True)


if __name__ == "__main__":
    main()
