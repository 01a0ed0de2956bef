"""Whether ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` changes cuBLAS's work on one
CUDA GPU. Deterministic cuBLAS needs it set before torch first touches
the card; ``chip_smoke.py`` sets it only for phase 28's child process,
so that the other phases, where kernels' plain versions and library
calls are timed, run as they would without it.

Run from anywhere: ``python3 rs_detection_tpu_torch/tools/cublas_workspace.py``.
Prints the card's name and power limit, then one JSON line a fresh
process, in the order unset, set, set, unset: the variable as the
process saw it, the device memory that each product's first call added
beside its output (the cuBLAS and cuBLASLt workspaces are taken from
torch's allocator at a handle's first use), and the median ms of 20
calls (CUDA events, after 3) of an f32 product with TF32 off (4096^3),
a bf16 product (8192^3) and a bf16 ``F.linear`` with a bias, cuBLASLt's
path ([32768, 1024] x [1024, 1024]). The last line gives each time's
ratio set / unset over the two pairs.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

VAR = "CUBLAS_WORKSPACE_CONFIG"
VALUE = ":4096:8"


def child() -> dict:
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    cases = {
        "mm_f32_4096": (lambda a, b: a @ b,
                        (rand(4096, 4096, dtype=torch.float32),
                         rand(4096, 4096, dtype=torch.float32))),
        "mm_bf16_8192": (lambda a, b: a @ b,
                         (rand(8192, 8192, dtype=torch.bfloat16),
                          rand(8192, 8192, dtype=torch.bfloat16))),
        "linear_bias_bf16": (F.linear,
                             (rand(32768, 1024, dtype=torch.bfloat16),
                              rand(1024, 1024, dtype=torch.bfloat16),
                              rand(1024, dtype=torch.bfloat16))),
    }
    out = {"var": os.environ.get(VAR), "torch": torch.__version__,
           "first_call_bytes": {}, "ms": {}}
    for name, (fn, args) in cases.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        y = fn(*args)
        torch.cuda.synchronize()
        out["first_call_bytes"][name] = (torch.cuda.memory_allocated()
                                         - before - y.numel()
                                         * y.element_size())
        del y
        for _ in range(3):
            fn(*args)
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out["ms"][name] = statistics.median(times)
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        print(json.dumps(child()), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for setting in (None, VALUE, VALUE, None):
        env = {k: v for k, v in os.environ.items() if k != VAR}
        if setting is not None:
            env[VAR] = setting
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child"], env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    ratio = {name: (runs[1]["ms"][name] + runs[2]["ms"][name])
             / (runs[0]["ms"][name] + runs[3]["ms"][name])
             for name in runs[0]["ms"]}
    same = all(r["first_call_bytes"] == runs[0]["first_call_bytes"]
               for r in runs)
    print(json.dumps({"set_over_unset_ms": ratio,
                      "first_call_bytes_equal": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
