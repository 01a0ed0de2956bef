"""The host-side polygon NMS core (``poly_nms.cc``), built by ``g++`` at
first use into ``build/native/`` at the repository root, named by a hash
of the source and flags, and bound with ``ctypes``. A failed build
raises: the tile merge has no silent numpy fallback."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "poly_nms.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libpolynms_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def poly_nms_library() -> ctypes.CDLL:
    """The loaded core, compiled on the first call where it is missing."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            done = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the polygon NMS core of the "
                               "tile merge cannot be built") from e
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {done.returncode}):\n"
                               f"{' '.join(cmd)}\n{done.stdout}{done.stderr}")
        os.replace(tmp, path)  # a concurrent process never sees a torn file
    lib = ctypes.CDLL(str(path))
    lib.poly_nms.restype = ctypes.c_int64
    lib.poly_nms.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_double, ctypes.c_void_p]
    return lib


def poly_nms_native(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy polygon NMS of ``dets`` [N, 9] (8 polygon coordinates and a
    score): kept indices, score-descending."""
    dets = np.ascontiguousarray(dets, np.float64)
    if dets.ndim != 2 or dets.shape[1] != 9:
        raise ValueError(f"poly_nms: dets must be [N, 9], got {dets.shape}")
    keep = np.zeros(dets.shape[0], np.int64)
    n_keep = poly_nms_library().poly_nms(
        dets.ctypes.data, dets.shape[0], float(thresh), keep.ctypes.data)
    return keep[:n_keep]
