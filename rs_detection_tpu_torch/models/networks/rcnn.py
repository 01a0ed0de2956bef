"""Two-stage rotated detector, inference (counterpart of
``rs_detection_tpu/models/networks/rcnn.py``): backbone -> neck -> RPN
-> bbox head, returning dense per-image detections."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class OrientedRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module, rpn: nn.Module,
                 bbox_head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn = rpn
        self.bbox_head = bbox_head

    def extract_feats(self, images):
        """images NHWC, cast to the parameters' dtype (the compute
        dtype) -> FPN levels, NHWC."""
        images = images.to(next(self.parameters()).dtype)
        return self.neck(self.backbone(images))

    @torch.inference_mode()
    def predict(self, images, scale_factor: Optional[torch.Tensor] = None):
        """Eval-mode forward on normalized NHWC images: dict of polys
        [B, P, 8], scores [B, P, C] and valid [B, P] (f32/bool). Boxes
        are divided by ``scale_factor`` [B] (default 1), the tile's
        resize factor."""
        feats = self.extract_feats(images)
        proposals, _, p_valid = self.rpn.get_proposals(*self.rpn(feats))
        if scale_factor is None:
            scale_factor = torch.ones(images.shape[0], device=images.device)
        return self.bbox_head.predict(feats, proposals, p_valid, scale_factor)
