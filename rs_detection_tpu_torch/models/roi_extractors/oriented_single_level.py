"""FPN-level-routing RoI feature extractors (counterpart of
``rs_detection_tpu/models/roi_extractors/oriented_single_level.py``): the
rotated ``OrientedSingleRoIExtractor`` (K1, backward K3, on CUDA
tensors), its legacy name ``RboxSingleRoIExtractor``, and the horizontal
``SingleRoIExtractor``.

The JAX ``SingleRoIExtractor`` pools every roi at every level and keeps
one by a one-hot mask (a static graph for XLA). Here each roi is pooled
at its own level only, a quarter of the gathers; the result equals the
masked sum wherever that is finite."""

from __future__ import annotations

from typing import Sequence

import torch

from ...ops.roi_align import (map_roi_levels, roi_align,
                              roi_align_rotated_pyramid)
from ...utils.registry import ROI_EXTRACTORS


@ROI_EXTRACTORS.register_module()
class OrientedSingleRoIExtractor:
    """Rotated RoIAlign of ``roi_layer``'s ``output_size`` x
    ``output_size`` bins of ``sampling_ratio`` x ``sampling_ratio``
    samples, each roi on the level ``finest_scale`` routes it to, after
    inflating it by ``extend_factor``. ``out_channels`` is recorded, as
    in the JAX extractor, and not used."""

    def __init__(self, roi_layer=None, out_channels: int = 256,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 extend_factor=(1.0, 1.0), finest_scale: float = 56):
        roi_layer = roi_layer or {}
        self.output_size = roi_layer.get("output_size", 7)
        self.sampling_ratio = max(int(roi_layer.get("sampling_ratio", 2)), 1)
        self.out_channels = out_channels
        self.featmap_strides = tuple(featmap_strides)
        self.extend_factor = tuple(extend_factor)
        self.finest_scale = float(finest_scale)

    def __call__(self, feats: Sequence[torch.Tensor], rois):
        """feats: per-level NHWC; rois [R, 6] (b, cx, cy, w, h, theta).
        Returns [R, P, P, C] in the features' dtype (the CUDA kernel on
        CUDA tensors)."""
        feats = [f.contiguous() for f in feats[:len(self.featmap_strides)]]
        # the reference inflates w by extend_factor[1] and h by [0]
        ef_h, ef_w = self.extend_factor
        rois = rois.float()
        rois = torch.cat([rois[:, :3], rois[:, 3:4] * ef_w,
                          rois[:, 4:5] * ef_h, rois[:, 5:6]], 1)
        return roi_align_rotated_pyramid(
            feats, rois, self.output_size, strides=self.featmap_strides,
            sampling_ratio=self.sampling_ratio,
            finest_scale=self.finest_scale)


@ROI_EXTRACTORS.register_module()
class RboxSingleRoIExtractor(OrientedSingleRoIExtractor):
    """The legacy name of the rotated extractor."""


@ROI_EXTRACTORS.register_module()
class SingleRoIExtractor:
    """Horizontal RoIAlign (``ops.roi_align.roi_align``) of each roi at
    the level ``finest_scale`` routes it to by sqrt(w h). ``out_channels``
    is recorded and not used, as in the JAX extractor."""

    def __init__(self, roi_layer=None, out_channels: int = 256,
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 finest_scale: float = 56):
        roi_layer = roi_layer or {}
        self.output_size = roi_layer.get("output_size", 7)
        self.sampling_ratio = max(int(roi_layer.get("sampling_ratio", 2)), 1)
        self.out_channels = out_channels
        self.featmap_strides = tuple(featmap_strides)
        self.finest_scale = float(finest_scale)

    def __call__(self, feats: Sequence[torch.Tensor], rois):
        """feats: per-level NHWC; rois [R, 5] (b, x1, y1, x2, y2).
        Returns [R, P, P, C] in the features' dtype."""
        p = self.output_size
        rois = rois.float()
        lvl = map_roi_levels(rois[:, 3] - rois[:, 1], rois[:, 4] - rois[:, 2],
                             len(self.featmap_strides), self.finest_scale)
        out = feats[0].new_zeros(rois.shape[0], p, p, feats[0].shape[-1])
        for i, stride in enumerate(self.featmap_strides):
            idx = torch.nonzero(lvl == i).flatten()
            if idx.numel():
                out[idx] = roi_align(feats[i], rois[idx], p, 1.0 / stride,
                                     self.sampling_ratio)
        return out
