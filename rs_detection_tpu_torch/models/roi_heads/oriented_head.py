"""Oriented R-CNN second stage, inference half (counterpart of
``rs_detection_tpu/models/roi_heads/oriented_head.py``): rotated RoI
features -> 2 shared FCs -> softmax cls (C+1, background last) and a
class-agnostic 5-dim ``OrientedDeltaXYWHTCoder`` regression; at test
time decode + rescale only (per-tile NMS is deferred to the merge)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ..boxes.coder import OrientedDeltaXYWHTCoder
from ..roi_extractors.oriented_single_level import OrientedSingleRoIExtractor


class OrientedHead(nn.Module):
    """The JAX head's defaults that no config changes are constants here:
    2 shared FCs, class-agnostic regression, coder stds (0.1, 0.1, 0.2,
    0.2, 0.1), and the extractor's 7x7 x 2x2 sampling over strides
    4-32 with rois inflated by (1.4, 1.2)."""

    NUM_SHARED_FCS = 2

    def __init__(self, num_classes: int, in_channels: int,
                 fc_out_channels: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.coder = OrientedDeltaXYWHTCoder(
            target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))
        self.extractor = OrientedSingleRoIExtractor(extend_factor=(1.4, 1.2))
        p = self.extractor.output_size
        cin = in_channels * p * p
        for i in range(self.NUM_SHARED_FCS):
            self.add_module(f"shared_fc{i}", nn.Linear(cin, fc_out_channels))
            cin = fc_out_channels
        self.fc_cls = nn.Linear(cin, num_classes + 1)
        self.fc_reg = nn.Linear(cin, 5)

    def forward_rois(self, feats, rois):
        """rois [R, 6] -> (cls_score [R, C+1], bbox_pred [R, 5]), f32.
        The FC input is the pooled [R, P, P, C] flattened in (P, P, C)
        order, as in the JAX head."""
        x = self.extractor(feats, rois)
        x = x.reshape(x.shape[0], -1)
        for i in range(self.NUM_SHARED_FCS):
            x = F.relu(getattr(self, f"shared_fc{i}")(x))
        return self.fc_cls(x).float(), self.fc_reg(x).float()

    def predict(self, feats, proposals, prop_valid, scale_factor):
        """Returns dict: polys [B, P, 8], scores [B, P, C] (softmax,
        background dropped), valid [B, P]."""
        b, p, _ = proposals.shape
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=proposals.device).repeat_interleave(p)
        rois = torch.cat([batch_idx[:, None], proposals.reshape(b * p, 5)], 1)
        cls_score, bbox_pred = self.forward_rois(feats, rois)
        scores = torch.softmax(cls_score, dim=-1)[:, :-1]
        obbs = self.coder.decode(rois[:, 1:], bbox_pred)
        # rescale to original image coordinates
        sf = scale_factor.float().repeat_interleave(p)[:, None]
        obbs = torch.cat([obbs[:, :4] / torch.clamp(sf, min=1e-6),
                          obbs[:, 4:]], 1)
        return dict(polys=B.obb2poly(obbs).reshape(b, p, 8),
                    scores=scores.reshape(b, p, self.num_classes),
                    valid=prop_valid)
