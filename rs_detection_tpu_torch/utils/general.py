"""File and schedule helpers of the runner (counterpart of
``rs_detection_tpu/utils/general.py``: ``build_file``,
``check_interval``, ``search_ckpt``, ``list_images``)."""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional

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
