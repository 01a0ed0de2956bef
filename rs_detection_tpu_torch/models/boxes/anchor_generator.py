"""Anchor generators (counterpart of
``rs_detection_tpu/models/boxes/anchor_generator.py``, re-implemented
because importing that module pulls in jax): the mmdet-v2 horizontal
``AnchorGenerator``, SSD's ``SSDAnchorGenerator`` on it, and the
rotated ``AnchorGeneratorRotatedS2ANet``
with its ``AnchorGeneratorYangXue`` and ``AnchorGeneratorRotated``
forms. Pure numpy: grids depend only on feature-map sizes and are cached
per size."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ...utils.registry import BOXES


def _meshgrid(x: np.ndarray, y: np.ndarray):
    """Row-major: x varies fastest."""
    return np.tile(x, len(y)), np.repeat(y, len(x))


@BOXES.register_module()
class AnchorGenerator:
    """Scale-major anchors centred on the stride grid's corners (the
    mmdet-v2 defaults, the only ones the Oriented RPN configs use), or
    on ``centers`` (one (x, y) a level) where given."""

    def __init__(self, strides: Sequence[int], ratios: Sequence[float],
                 scales: Sequence[float], centers=None):
        self.strides = [int(s) for s in strides]
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.centers = centers
        self.base_anchors = self.gen_base_anchors()
        self._cache = {}

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    @property
    def num_base_anchors(self) -> List[int]:
        return [ba.shape[0] for ba in self.base_anchors]

    def gen_base_anchors(self) -> List[np.ndarray]:
        return [self._single_level(
            s, None if self.centers is None else self.centers[i])
            for i, s in enumerate(self.strides)]

    def _single_level(self, base_size, center=None) -> np.ndarray:
        """The level's anchors at the origin (or at ``center``), in the
        JAX generator's f32 arithmetic."""
        w = h = float(base_size)
        x_c, y_c = (0.0, 0.0) if center is None else center
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack([x_c - 0.5 * ws, y_c - 0.5 * hs,
                         x_c + 0.5 * ws, y_c + 0.5 * hs], -1) \
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


@BOXES.register_module()
class SSDAnchorGenerator(AnchorGenerator):
    """SSD's multibox anchors (the JAX ``SSDAnchorGenerator``): a level's
    min / max sizes from ``basesize_ratio_range`` over ``input_size``,
    the scales 1 and sqrt(max / min), the ratios 1, 1/r and r of each r
    of the level, centred on ((s - 1) / 2, (s - 1) / 2). The JAX index
    list keeps 5 or 9 anchors a position where mmdet keeps 4 or 6
    (ROADMAP.md, "Known inexact spots"); the port keeps JAX's."""

    def __init__(self, strides, ratios, basesize_ratio_range,
                 input_size=300):
        self.strides = [int(s) for s in strides]
        self.input_size = input_size
        self.centers = [((s - 1) / 2.0, (s - 1) / 2.0) for s in self.strides]
        min_ratio, max_ratio = basesize_ratio_range
        min_ratio, max_ratio = int(min_ratio * 100), int(max_ratio * 100)
        step = int(math.floor(max_ratio - min_ratio) / (len(strides) - 2))
        min_sizes, max_sizes = [], []
        for ratio in range(int(min_ratio), int(max_ratio) + 1, step):
            min_sizes.append(int(input_size * ratio / 100))
            max_sizes.append(int(input_size * (ratio + step) / 100))
        if min_ratio == 20:
            min_sizes.insert(0, int(input_size * 10 / 100))
            max_sizes.insert(0, int(input_size * 20 / 100))
        else:
            min_sizes.insert(0, int(input_size * 7 / 100))
            max_sizes.insert(0, int(input_size * 15 / 100))
        self.scales_per_level, self.ratios_per_level = [], []
        for k in range(len(self.strides)):
            anchor_ratio = [1.0]
            for r in ratios[k]:
                anchor_ratio += [1 / r, r]
            self.ratios_per_level.append(np.array(anchor_ratio, np.float32))
            self.scales_per_level.append(np.array(
                [1.0, np.sqrt(max_sizes[k] / min_sizes[k])], np.float32))
        self.base_sizes = min_sizes
        self.base_anchors = self.gen_base_anchors()
        self._cache = {}

    def gen_base_anchors(self) -> List[np.ndarray]:
        """Each level's anchors scale-minor (the scales vary slowest), in
        the JAX generator's f32 arithmetic, less the one that JAX's index
        list [0, n, 2, ..., 2n - 1] over the 2n of them leaves out: the
        scale-1 anchor of the ratio 1 / r of the level's first r."""
        out = []
        for size, scales, ratios, (x_c, y_c) in zip(
                self.base_sizes, self.scales_per_level,
                self.ratios_per_level, self.centers):
            w = h = float(size)
            h_ratios = np.sqrt(ratios)
            w_ratios = 1.0 / h_ratios
            ws = (w * scales[:, None] * w_ratios[None, :]).reshape(-1)
            hs = (h * scales[:, None] * h_ratios[None, :]).reshape(-1)
            anchors = np.stack([x_c - 0.5 * ws, y_c - 0.5 * hs,
                                x_c + 0.5 * ws, y_c + 0.5 * hs], -1)
            out.append(np.delete(anchors, 1, 0).astype(np.float32))
        return out


@BOXES.register_module()
class AnchorGeneratorRotatedS2ANet:
    """Rotated anchors with the legacy 0.5*(size-1) center
    (reference ``anchor_generator.py:8-91``)."""

    def __init__(self, base_size, scales, ratios, angles=(0,),
                 scale_major=True, ctr=None, mode="S2ANet"):
        self.base_size = base_size
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.angles = np.asarray(angles, np.float32)
        self.ctr = ctr
        self.mode = mode
        self.base_anchors = self.gen_base_anchors()
        self._cache = {}

    @property
    def num_base_anchors(self) -> int:
        return self.base_anchors.shape[0]

    def gen_base_anchors(self) -> np.ndarray:
        w = h = float(self.base_size)
        if self.ctr is None:
            x_ctr = 0.5 * (w - 1)
            y_ctr = 0.5 * (h - 1)
        else:
            x_ctr, y_ctr = self.ctr
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        # scale-major ordering: (ratio, scale, angle)
        ws = (w * w_ratios[:, None, None] * self.scales[None, :, None]
              * np.ones_like(self.angles)[None, None, :]).reshape(-1)
        hs = (h * h_ratios[:, None, None] * self.scales[None, :, None]
              * np.ones_like(self.angles)[None, None, :]).reshape(-1)
        angles = np.tile(self.angles, len(self.scales) * len(self.ratios))
        if self.mode == "YangXue":
            # w/h swap convention (AnchorGeneratorYangXue :651)
            ws, hs = hs, ws
        n = ws.shape[0]
        return np.stack([np.full(n, x_ctr, np.float32),
                         np.full(n, y_ctr, np.float32),
                         ws, hs, angles], axis=-1).astype(np.float32)

    def grid_anchors(self, featmap_size: Tuple[int, int],
                     stride: int = 16) -> np.ndarray:
        key = (featmap_size, stride)
        if key not in self._cache:
            fh, fw = featmap_size
            sx = np.arange(fw, dtype=np.float32) * stride
            sy = np.arange(fh, dtype=np.float32) * stride
            xx, yy = _meshgrid(sx, sy)
            shifts = np.stack([xx, yy, np.zeros_like(xx),
                               np.zeros_like(xx), np.zeros_like(xx)], -1)
            all_anchors = (self.base_anchors[None, :, :]
                           + shifts[:, None, :]).reshape(-1, 5)
            self._cache[key] = all_anchors.astype(np.float32)
        return self._cache[key]

    def valid_flags(self, featmap_size, valid_size) -> np.ndarray:
        fh, fw = featmap_size
        vh, vw = valid_size
        vx = np.zeros(fw, bool)
        vy = np.zeros(fh, bool)
        vx[:vw] = True
        vy[:vh] = True
        xx, yy = _meshgrid(vx, vy)
        valid = xx & yy
        return np.repeat(valid, self.num_base_anchors)


@BOXES.register_module()
class AnchorGeneratorYangXue(AnchorGeneratorRotatedS2ANet):
    """w/h-swapped convention (reference ``:651``)."""

    def __init__(self, *a, **kw):
        kw["mode"] = "YangXue"
        super().__init__(*a, **kw)


@BOXES.register_module()
class AnchorGeneratorRotated(AnchorGeneratorRotatedS2ANet):
    """Generic rotated generator (reference ``:495-649``); same math as
    the S2ANet variant with configurable center."""
