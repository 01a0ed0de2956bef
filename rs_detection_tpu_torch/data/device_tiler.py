"""The scene tiler on the scene's device (counterpart of
``rs_detection_tpu/data/device_tiler.py``): the sliding window of
``devkits/img_split.py:splitbase.SplitSingle`` (``slide = subsize -
gap``, the last window clamped to ``dim - subsize``), cut from one scene
tensor into the tile batch. A scene smaller than a tile is zero-padded
at its right and bottom. Tiles are in row-major order (``ups`` outer),
as in the JAX tiler; ``img_split`` walks the same windows left-major.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def tile_positions(dim: int, subsize: int, slide: int) -> List[int]:
    """Window start positions along one axis: the loop of
    ``img_split.py:splitbase.SplitSingle`` (clamped final window, no
    duplicates)."""
    pos = []
    left = 0
    while left < dim:
        if left + subsize >= dim:
            left = max(dim - subsize, 0)
        pos.append(left)
        if left + subsize >= dim:
            break
        left += slide
    return pos


def tile_scene(scene: torch.Tensor, subsize: int = 1024, gap: int = 200
               ) -> Tuple[torch.Tensor, np.ndarray]:
    """Cut one [H, W, C] scene (any dtype, kept) into its windows.

    Returns (tiles [N, subsize, subsize, C] on the scene's device,
    offsets [N, 2] int64 numpy: (left, up) per tile)."""
    h, w = int(scene.shape[0]), int(scene.shape[1])
    slide = subsize - gap
    lefts = tile_positions(w, subsize, slide)
    ups = tile_positions(h, subsize, slide)
    if h < subsize or w < subsize:
        scene = F.pad(scene, (0, 0, 0, max(subsize - w, 0),
                              0, max(subsize - h, 0)))
    tiles = torch.stack([scene[u:u + subsize, lf:lf + subsize]
                         for u in ups for lf in lefts])
    offsets = np.asarray([(lf, u) for u in ups for lf in lefts], np.int64)
    return tiles, offsets
