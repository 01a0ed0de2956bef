"""FPN-level-routing rotated RoI feature extractor (counterpart of
``rs_detection_tpu/models/roi_extractors/oriented_single_level.py:
OrientedSingleRoIExtractor``)."""

from __future__ import annotations

from typing import Sequence

import torch

from ...ops.roi_align import roi_align_rotated_pyramid


class OrientedSingleRoIExtractor:
    """7x7 bins of 2x2 samples over the strides 4-32 levels, routed by
    ``finest_scale`` 56 (the values every Oriented R-CNN config uses)."""

    output_size = 7
    sampling_ratio = 2
    featmap_strides = (4, 8, 16, 32)
    finest_scale = 56.0

    def __init__(self, extend_factor=(1.0, 1.0)):
        self.extend_factor = tuple(extend_factor)

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
