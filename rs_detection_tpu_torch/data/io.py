"""Image decoding for the data pipeline (counterpart of
``rs_detection_tpu/data/io.py``), through Pillow."""

from __future__ import annotations

import numpy as np
from PIL import Image


def load_rgb(path: str) -> Image.Image:
    """Decode to a PIL RGB image (the transforms work on PIL images
    before batching)."""
    with Image.open(path) as img:
        return img.convert("RGB")


def load_rgb_array(path: str) -> np.ndarray:
    """Decode to an RGB8 [H, W, 3] array."""
    return np.asarray(load_rgb(path), np.uint8)
