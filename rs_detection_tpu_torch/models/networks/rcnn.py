"""Two-stage rotated detector (counterpart of
``rs_detection_tpu/models/networks/rcnn.py``): backbone -> neck -> RPN
-> bbox head. ``loss`` is the training forward (the merged loss dict of
the RPN and the head), ``predict`` the inference one (dense per-image
detections). ``RCNN`` is the base of ``OrientedRCNN`` here and of the
hbb-RPN networks of ``roi_transformer.py``."""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import torch
from torch import nn

from ...utils.registry import (BACKBONES, HEADS, MODELS, NECKS,
                               build_from_cfg)
from .. import backbones  # noqa: F401  (registers VAN and ResNet forms)
from ..backbones.resnet import ResNet
from ..necks.fpn import FPN
from ..roi_heads import oriented_head_variants  # noqa: F401  (registers)
from ..roi_heads.oriented_head import OrientedHead
from ..roi_heads.oriented_rpn_head import OrientedRPNHead
from .compat import adapt_rpn_cfg, normalize_cfg


def _build(cfg, registry, default):
    """A sub-module from its config section (normalized as in the JAX
    package), ``default()`` when None, or the module itself."""
    if cfg is None:
        return default()
    if isinstance(cfg, Mapping):
        return build_from_cfg(normalize_cfg(cfg, registry), registry)
    return cfg


def _resnet50():
    return ResNet(depth=50)


def _dtype(name):
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"RCNN: compute_dtype {name!r} is not a floating "
                         f"dtype")
    return dtype


class RCNN(nn.Module):
    """The two-stage detector of the JAX ``RCNN``. ``backbone``, ``neck``,
    ``rpn`` and ``bbox_head`` are modules or their config sections
    (``type=`` dicts, built through the registries; ``default_rpn`` /
    ``default_head`` when None). ``compute_dtype`` (a torch dtype or its
    name, e.g. "bfloat16"): the dtype the images are cast to, and so the
    activations'; the parameters' dtype when None. ``pretrained`` is read
    by the runner. Every network takes the seven mmdet-v1 sections of the
    JAX ``RCNN`` (``rpn_head``, ``bbox_roi_extractor``,
    ``rbbox_roi_extractor``, ``rbbox_head``, ``shared_head``,
    ``train_cfg``, ``test_cfg``) and reads what its JAX twin reads:
    ``rpn_head`` stands for ``rpn`` when that is None (where
    ``reads_rpn_head``), a subclass's ``build_head`` reads the cascade's
    sections, and the rest are ignored, ``shared_head`` everywhere, as in
    JAX."""

    # the JAX GlidingVertex builds its RPN from ``rpn`` alone
    reads_rpn_head = True
    default_rpn = OrientedRPNHead
    default_head = OrientedHead

    def __init__(self, backbone=None, neck=None, rpn=None, bbox_head=None,
                 compute_dtype=None, rpn_head=None, bbox_roi_extractor=None,
                 rbbox_roi_extractor=None, rbbox_head=None, shared_head=None,
                 train_cfg=None, test_cfg=None, pretrained=None):
        super().__init__()
        legacy = dict(rpn_head=rpn_head, bbox_roi_extractor=bbox_roi_extractor,
                      rbbox_roi_extractor=rbbox_roi_extractor,
                      rbbox_head=rbbox_head, shared_head=shared_head,
                      train_cfg=train_cfg, test_cfg=test_cfg)
        if rpn is None and self.reads_rpn_head:
            rpn = adapt_rpn_cfg(rpn_head)
        self.backbone = _build(backbone, BACKBONES, _resnet50)
        self.neck = _build(neck, NECKS, FPN)
        self.rpn = _build(rpn, HEADS, self.default_rpn)
        self.bbox_head = self.build_head(bbox_head, legacy)
        self.compute_dtype = _dtype(compute_dtype)

    def build_head(self, bbox_head, legacy):
        """The second stage from ``bbox_head`` (and the legacy sections a
        subclass reads)."""
        return _build(bbox_head, HEADS, self.default_head)

    def extract_feats(self, images):
        """images NHWC, cast to the compute dtype -> FPN levels, NHWC."""
        dtype = self.compute_dtype or next(self.parameters()).dtype
        return self.neck(self.backbone(images.to(dtype)))

    def loss(self, images, targets, generator) -> Dict[str, torch.Tensor]:
        """Training losses of normalized NHWC ``images`` (call in train
        mode). ``targets``: dict of dense tensors "rboxes" [B, G, 5],
        "gt_mask" [B, G], "labels" [B, G] (1-based), "img_hw" [B, 2], and
        for the hbb-RPN networks "hboxes" [B, G, 4].
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


@MODELS.register_module()
class OrientedRCNN(RCNN):
    """The competition model: ``OrientedRPNHead`` and ``OrientedHead`` by
    default; of the legacy sections it reads ``rpn_head``."""
