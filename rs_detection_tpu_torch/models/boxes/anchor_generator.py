"""mmdet-v2 horizontal anchor generator (counterpart of
``rs_detection_tpu/models/boxes/anchor_generator.py:AnchorGenerator``,
re-implemented because importing that module pulls in jax). Pure numpy:
grids depend only on feature-map sizes and are cached per size."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from ...utils.registry import BOXES


def _meshgrid(x: np.ndarray, y: np.ndarray):
    """Row-major: x varies fastest."""
    return np.tile(x, len(y)), np.repeat(y, len(x))


@BOXES.register_module()
class AnchorGenerator:
    """Scale-major anchors centred on the stride grid's corners (the
    mmdet-v2 defaults, the only ones the Oriented RPN configs use)."""

    def __init__(self, strides: Sequence[int], ratios: Sequence[float],
                 scales: Sequence[float]):
        self.strides = [int(s) for s in strides]
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.base_anchors = self.gen_base_anchors()
        self._cache = {}

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [ba.shape[0] for ba in self.base_anchors]

    def gen_base_anchors(self) -> List[np.ndarray]:
        return [self._single_level(s) for s in self.strides]

    def _single_level(self, base_size) -> np.ndarray:
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (base_size * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (base_size * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], -1) \
            .astype(np.float32)

    def grid_anchors(self, featmap_sizes) -> List[np.ndarray]:
        """Per-level ``[H_l * W_l * A, 4]`` anchors, ordered (h, w, a)."""
        return [self.single_level_grid_anchors(featmap_sizes[i], i)
                for i in range(self.num_levels)]

    def single_level_grid_anchors(self, featmap_size, level: int):
        key = (tuple(featmap_size), level)
        if key not in self._cache:
            fh, fw = featmap_size
            s = self.strides[level]
            xx, yy = _meshgrid(np.arange(fw, dtype=np.float32) * s,
                               np.arange(fh, dtype=np.float32) * s)
            shifts = np.stack([xx, yy, xx, yy], -1)
            anchors = (self.base_anchors[level][None, :, :]
                       + shifts[:, None, :]).reshape(-1, 4)
            self._cache[key] = anchors.astype(np.float32)
        return self._cache[key]

    def valid_flags(self, featmap_sizes, pad_shape) -> List[np.ndarray]:
        """Per-level [H_l * W_l * A] bool: anchors whose grid cell lies in
        the ``pad_shape`` (h, w) region of the image."""
        out = []
        for i in range(self.num_levels):
            fh, fw = featmap_sizes[i]
            s = self.strides[i]
            vh = min(int(math.ceil(pad_shape[0] / s)), fh)
            vw = min(int(math.ceil(pad_shape[1] / s)), fw)
            vx = np.zeros(fw, bool)
            vy = np.zeros(fh, bool)
            vx[:vw] = True
            vy[:vh] = True
            xx, yy = _meshgrid(vx, vy)
            out.append(np.repeat(xx & yy, self.num_base_anchors[i]))
        return out
