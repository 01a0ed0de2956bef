"""Build and load the port's CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library
lands in ``build/torch_kernels/`` at the repository root, named
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads in milliseconds. Nothing here runs at import time:
the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes/restype of each exported function; every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    "rs_van_mlp_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "rs_van_mlp_scratch_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "rs_van_mlp_fwd": ([_P] * 9 + [_I] * 7 + [_P], _I),
    "rs_van_mlp_int8_design": ([_I, _I, _I], _I),
    "rs_van_mlp_int8_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "rs_van_mlp_int8_scratch_bytes": ([_I, _I, _I], ctypes.c_size_t),
    "rs_van_mlp_int8_pack": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "rs_van_mlp_int8_fwd": ([_P] * 9 + [_I] * 7 + [_P], _I),
    "rs_van_attn_design": ([_I, _I], _I),
    "rs_van_attn_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "rs_van_attn_scratch_bytes": ([_I, _I], ctypes.c_size_t),
    "rs_van_attn_proj1": ([_P] * 7 + [_L, _I, _I, _P], _I),
    "rs_van_attn_tail": ([_P] * 12 + [_L, _I, _I, _P], _I),
    "rs_dw_conv_fwd_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "rs_dw_conv_fwd": ([_P] * 4 + [_I] * 6 + [_L, _L] + [_I] * 3 + [_P], _I),
    "rs_dw_conv_fwd_stream_smem_bytes": ([_I] * 3, ctypes.c_size_t),
    "rs_dw_conv_fwd_stream": (
        [_P] * 4 + [_I] * 6 + [_L, _L] + [_I] * 3 + [_P], _I),
    "rs_roi_align_rotated_pyramid_fwd": (
        [_P] * 4 + [_I] * 11 + [_F] * 4 + [_P, _I, _I, _I, _F, _P, _I, _I, _P],
        _I),
    "rs_roi_align_rotated_pyramid_bwd": (
        [_P] + [_I] * 11 + [_F] * 4 + [_P, _I, _I, _I, _F] + [_P] * 8
        + [_I, _I, _P], _I),
    "rs_roi_align_rotated_pyramid_bwd_records": (
        [_I] * 10 + [_F] * 4 + [_P, _I, _I, _I, _F, _P, _P, _P], _I),
    "rs_roi_align_rotated_pyramid_bwd_gather": (
        [_P] * 4 + [_I] * 12 + [_P] * 4 + [_I, _I, _P], _I),
    "rs_dw_wgrad_plan": ([_L] * 8 + [_I] * 7 + [ctypes.POINTER(_I)], _I),
    "rs_dw_wgrad": ([_P, _P] + [_L] * 8 + [_I] * 8 + [_P] * 3, _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librs_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = {s: tmp.with_name(f"{tmp.name}.{s.stem}.o")
            for s in _sources() if s.suffix == ".cu"}
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in objs.items()]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        for cmd, proc in zip(cmds, procs):
            output, _ = proc.communicate()
            _check(cmd, proc.returncode, output)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *[str(o) for o in objs.values()]]
        done = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, done.returncode, done.stdout + done.stderr)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
        for o in objs.values():
            o.unlink(missing_ok=True)
    os.replace(tmp, path)  # atomic: a concurrent process never sees a torn file
    return path


def _check(cmd, returncode, output):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {returncode}):\n"
                           f"{' '.join(cmd)}\n{output}")


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
