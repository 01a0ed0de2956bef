"""Two-stage rotated detector (counterpart of
``rs_detection_tpu/models/networks/rcnn.py``): backbone -> neck -> RPN
-> bbox head. ``loss`` is the training forward (the merged loss dict of
the RPN and the head), ``predict`` the inference one (dense per-image
detections)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


class OrientedRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module, rpn: nn.Module,
                 bbox_head: nn.Module,
                 compute_dtype: Optional[torch.dtype] = None):
        """``compute_dtype``: the dtype the images are cast to, and so
        the activations' (the JAX ``compute_dtype``); the parameters'
        dtype when None."""
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn = rpn
        self.bbox_head = bbox_head
        self.compute_dtype = compute_dtype

    def extract_feats(self, images):
        """images NHWC, cast to the compute dtype -> FPN levels, NHWC."""
        dtype = self.compute_dtype or next(self.parameters()).dtype
        return self.neck(self.backbone(images.to(dtype)))

    def loss(self, images, targets, generator) -> Dict[str, torch.Tensor]:
        """Training losses of normalized NHWC ``images`` (call in train
        mode). ``targets``: dict of dense tensors "rboxes" [B, G, 5],
        "gt_mask" [B, G], "labels" [B, G] (1-based), "img_hw" [B, 2].
        ``generator`` (on the images' device) drives both samplers. The
        proposals come from the detached RPN outputs, so the head's loss
        reaches the backbone only through the RoI features."""
        feats = self.extract_feats(images)
        cls_scores, bbox_preds = self.rpn(feats)
        losses = self.rpn.loss(cls_scores, bbox_preds, targets, generator)
        proposals, _, p_valid = self.rpn.get_proposals(
            [c.detach() for c in cls_scores], [r.detach() for r in bbox_preds])
        losses.update(self.bbox_head.loss(feats, proposals, p_valid, targets,
                                          generator))
        return losses

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
