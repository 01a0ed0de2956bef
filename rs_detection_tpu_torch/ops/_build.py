"""Build and load the port's CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``build/torch_kernels/`` at the repository root, named
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes/restype of each exported function; every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits
SIGNATURES = {
    "rs_van_mlp_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "rs_van_mlp_fwd": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "rs_roi_align_rotated_pyramid_fwd": (
        [_P] * 4 + [_I] * 11 + [_F] * 4 + [_P, _I, _I, _I, _F, _P, _I, _I, _P],
        _I),
    "rs_roi_align_rotated_pyramid_bwd": (
        [_P] + [_I] * 11 + [_F] * 4 + [_P, _I, _I, _I, _F] + [_P] * 8
        + [_I, _I, _P], _I),
    "rs_dw_wgrad_smem_bytes": ([_I, _I, _I], ctypes.c_size_t),
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
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent process never sees a torn file
    return path


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
