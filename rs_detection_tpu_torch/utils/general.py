"""General helpers (counterpart of ``rs_detection_tpu/utils/general.py``):
``multi_apply``, ``parse_losses``, ``set_random_seed`` (which seeds torch
too), ``sync`` (tensors to host numbers: the training step's losses are
already the global batch's, as the JAX mesh's outputs are), ``to_np``,
``unmap`` (numpy arrays or tensors, on the tensor's device), and the
runner's file and schedule helpers ``build_file``, ``check_interval``,
``search_ckpt``, ``list_images``."""

from __future__ import annotations

import glob
import os
import random
import re
from typing import Dict, List, Optional

import numpy as np
import torch

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def build_file(work_dir: str, prefix: str) -> str:
    """Make ``work_dir/prefix`` parents and return the path."""
    path = os.path.join(work_dir, prefix)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def check_interval(step: Optional[int], interval: Optional[int]) -> bool:
    if step is None or interval is None or interval <= 0:
        return False
    return (step + 1) % interval == 0


def search_ckpt(work_dir: str) -> Optional[str]:
    """The highest-epoch checkpoint file or directory under
    ``work_dir/checkpoints``, or None."""
    files = glob.glob(os.path.join(work_dir, "checkpoints", "ckpt_*"))
    if not files:
        return None

    def epoch_of(f):
        m = re.search(r"ckpt_(\d+)", os.path.basename(f))
        return int(m.group(1)) if m else -1

    return max(files, key=epoch_of)


def list_images(img_dir: str) -> List[str]:
    """Every image file under ``img_dir`` (recursively), sorted."""
    out = []
    for root, _, files in os.walk(img_dir):
        out += [os.path.join(root, f) for f in files
                if f.lower().endswith(IMG_EXTENSIONS)]
    return sorted(out)


def multi_apply(func, *args, **kwargs):
    """``func`` over the zipped ``args``; its tuples of results as a
    tuple of lists."""
    results = [func(*a, **kwargs) for a in zip(*args)]
    return tuple(map(list, zip(*results)))


def parse_losses(losses: Dict) -> float:
    """The sum of every entry whose key contains 'loss'."""
    return sum(float(to_np(v).sum()) for k, v in losses.items()
               if "loss" in k)


def set_random_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators (every device's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def sync(data):
    """Fetch tensors (nested in dicts, lists and tuples) to the host: a
    0-d value as a Python number, others as numpy arrays; anything else
    as it is."""
    if isinstance(data, dict):
        return {k: sync(v) for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        return type(data)(sync(v) for v in data)
    try:
        arr = to_np(data)
        return arr.item() if arr.ndim == 0 else arr
    except Exception:
        return data


def to_np(x) -> np.ndarray:
    """A tensor (any device, any grad state) or array-like as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def unmap(data, count: int, inds, fill=0):
    """``data``'s rows scattered into a ``count``-row array at ``inds``,
    the other rows ``fill`` (undoes a valid-anchor selection): numpy in,
    numpy out; a tensor in, a tensor on its device out."""
    shape = (count,) + tuple(data.shape[1:])
    if isinstance(data, np.ndarray):
        out = np.full(shape, fill, dtype=data.dtype)
        out[np.asarray(inds)] = data
        return out
    out = torch.full(shape, fill, dtype=data.dtype, device=data.device)
    out[torch.as_tensor(inds, device=data.device)] = data
    return out
