"""R3Det, the refined single-stage rotated detector (counterpart of
``rs_detection_tpu/models/networks/r3det.py``).

A ``RetinaHead`` first stage; per cell, the first anchor's box decoded
from the stage's detached deltas (``refined_anchors``); the
``FeatureRefineModule`` (a 1x5 then 5x1 conv plus a 1x1 conv, then the
``ops/fr`` gather at the refined boxes, added back as a residual); and
the ``R3DetRefineHead``, which classifies and regresses against the
refined boxes (its assigner fixed at 0.6 / 0.5, as in JAX).

As the JAX network, it builds one refine stage from the first entry of
the config's ``refine_heads`` and ``frm_cfgs`` lists (the zoo config
names two; ROADMAP.md, Queue 3) and reads neither the config's top-level
``test_cfg`` nor its ``train_cfg``. Inference decodes the refine head's
deltas against the refined boxes and keeps the first stage's ``nms_pre``,
thresholds and ``max_per_img``. Plain PyTorch and cuDNN convs on every
device: the JAX network reaches no Pallas kernel."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.fr import feature_refine
from ...ops.nms import top_k
from ...ops.nms_rotated import multiclass_nms_rotated_jit
from ...utils.registry import HEADS, MODELS
from ..boxes.anchor_target import anchor_target_single
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import DeltaXYWHABBoxCoder
from ..boxes.sampler import PseudoSampler
from ..losses.common import sigmoid_focal_loss, smooth_l1_loss
from ..roi_heads.retina_head import RetinaHead
from ..utils.modules import conv2d
from .compat import adapt_refine_head
from .rcnn import _build
from .single_stage import SingleStageDetector


def _normal_init(module, g):
    """N(0, 0.01) conv weights and zero biases, as the JAX initializers."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.01, generator=g)
            nn.init.zeros_(m.bias)


class FeatureRefineModule(nn.Module):
    """Per level ``conv_1_5_{i}`` -> ``conv_5_1_{i}`` plus ``conv_1_1_{i}``
    (the flax names), then ``feature_refine`` at the level's refined
    boxes; the output is the input plus the sampled features."""

    def __init__(self, in_channels: int = 256,
                 featmap_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 points: int = 1):
        super().__init__()
        self.featmap_strides = tuple(featmap_strides)
        self.points = points
        c = in_channels
        for i in range(len(self.featmap_strides)):
            self.add_module(f"conv_1_5_{i}",
                            nn.Conv2d(c, c, (1, 5), padding=(0, 2)))
            self.add_module(f"conv_5_1_{i}",
                            nn.Conv2d(c, c, (5, 1), padding=(2, 0)))
            self.add_module(f"conv_1_1_{i}", nn.Conv2d(c, c, 1))

    def init_weights(self, g: torch.Generator) -> None:
        with torch.no_grad():
            _normal_init(self, g)

    def forward(self, feats, best_rbboxes):
        """NHWC levels and per level the refined boxes [N, H, W, 5] ->
        NHWC levels."""
        outs = []
        for i, (x, boxes) in enumerate(zip(feats, best_rbboxes)):
            xc = x.permute(0, 3, 1, 2)
            f1 = conv2d(getattr(self, f"conv_5_1_{i}"),
                        conv2d(getattr(self, f"conv_1_5_{i}"), xc))
            mixed = (f1 + conv2d(getattr(self, f"conv_1_1_{i}"), xc)).permute(
                0, 2, 3, 1)
            refined = feature_refine(mixed, boxes.to(mixed.dtype),
                                     1.0 / self.featmap_strides[i],
                                     points=self.points)
            outs.append(x + (refined - mixed))
        return outs


@HEADS.register_module()
class R3DetRefineHead(nn.Module):
    """The refine stage: ``stacked_convs`` ReLU 3x3 convs a branch
    (``cls_{i}``, ``reg_{i}``), ``out_cls`` (``num_classes - 1`` sigmoid
    logits, the bias at the -log 99 prior) and ``out_reg`` (5 deltas),
    one box a cell. ``num_classes`` counts the background."""

    def __init__(self, num_classes: int = 16, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 target_stds: Sequence[float] = (1.0,) * 5):
        super().__init__()
        self.num_classes = num_classes
        self.cls_out_channels = num_classes - 1
        self.stacked_convs = stacked_convs
        self.target_stds = tuple(target_stds)
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_{i}", nn.Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1))
        tower = feat_channels if stacked_convs else in_channels
        self.out_cls = nn.Conv2d(tower, self.cls_out_channels, 3, padding=1)
        self.out_reg = nn.Conv2d(tower, 5, 3, padding=1)
        self.coder = DeltaXYWHABBoxCoder(target_stds=self.target_stds)
        self.assigner = MaxIoUAssigner(
            pos_iou_thr=0.6, neg_iou_thr=0.5, min_pos_iou=0.0,
            iou_calculator=dict(type="BboxOverlaps2D_rotated"))
        self.sampler = PseudoSampler()

    def init_weights(self, g: torch.Generator) -> None:
        with torch.no_grad():
            _normal_init(self, g)
            nn.init.constant_(self.out_cls.bias, -math.log(99.0))

    def _tower(self, branch, x):
        for i in range(self.stacked_convs):
            x = F.relu(conv2d(getattr(self, f"{branch}_{i}"), x))
        return x

    def forward(self, feats):
        """NHWC levels -> (cls_scores [N, H, W, C - 1], bbox_preds
        [N, H, W, 5]) per level."""
        cls_scores, bbox_preds = [], []
        for f in feats:
            x = f.permute(0, 3, 1, 2)
            cls_scores.append(conv2d(self.out_cls, self._tower(
                "cls", x)).permute(0, 2, 3, 1))
            bbox_preds.append(conv2d(self.out_reg, self._tower(
                "reg", x)).permute(0, 2, 3, 1))
        return cls_scores, bbox_preds

    def loss(self, cls_scores, bbox_preds, refined_anchors, targets):
        """Focal and smooth-L1 (beta 1/9) losses against the refined boxes
        (per level [B, H * W, 5]), over the batch's sum of
        ``max(num_pos, 1)``."""
        b = cls_scores[0].shape[0]
        c = self.cls_out_channels
        anchors = torch.cat([a.reshape(b, -1, 5) for a in refined_anchors],
                            1).float()
        dev = anchors.device
        res = anchor_target_single(
            anchors, torch.ones(anchors.shape[:2], dtype=torch.bool,
                                device=dev),
            targets["rboxes"].float(), targets["gt_mask"].bool(),
            targets["labels"], self.assigner, self.sampler,
            self.coder.encode, None)
        num_total = res.num_pos.clamp(min=1).sum().float()
        cls = torch.cat([s.reshape(b, -1, c) for s in cls_scores], 1)
        reg = torch.cat([r.reshape(b, -1, 5) for r in bbox_preds], 1)
        classes = torch.arange(1, c + 1, device=dev)
        onehot = (res.labels[..., None] == classes).float()
        return dict(
            loss_refine_cls=sigmoid_focal_loss(
                cls.reshape(-1, c).float(), onehot.reshape(-1, c),
                res.label_weights.reshape(-1), avg_factor=num_total),
            loss_refine_bbox=smooth_l1_loss(
                reg.reshape(-1, 5).float(), res.bbox_targets.reshape(-1, 5),
                res.bbox_weights.reshape(-1, 5), beta=1.0 / 9.0,
                avg_factor=num_total))


@MODELS.register_module()
class R3Det(SingleStageDetector):
    """The JAX network's sections: the single-stage ones (a ``RetinaHead``
    by default, R3Det's ``RRetinaHead`` section through
    ``compat.adapt_retina_like``), ``refine_head`` (a section or module)
    or the first of ``refine_heads`` (through
    ``compat.adapt_refine_head``), ``frm`` (a module) or the first of
    ``frm_cfgs``; ``num_refine_stages`` is read by nothing,
    as in JAX. Submodules ``backbone``, ``neck``, ``bbox_head``, ``frm``,
    ``refine_head`` (the flax ``_frm`` / ``_refine_head``)."""

    default_head = RetinaHead

    def __init__(self, backbone=None, neck=None, bbox_head=None,
                 roi_heads=None, rpn_net=None, pretrained=None,
                 refine_head=None, frm=None, refine_heads=None,
                 frm_cfgs=None, num_refine_stages=None):
        super().__init__(backbone, neck, bbox_head, roi_heads, rpn_net,
                         pretrained)
        head = self.bbox_head
        width = head.feat_channels
        if refine_head is None and refine_heads:
            refine_head = adapt_refine_head(list(refine_heads)[0])
        self.refine_head = _build(refine_head, HEADS, lambda: R3DetRefineHead(
            num_classes=head.num_classes, in_channels=width,
            feat_channels=width))
        if frm is None:
            first = dict(list(frm_cfgs)[0]) if frm_cfgs else {}
            frm = FeatureRefineModule(
                in_channels=first.get("in_channels",
                                      256 if frm_cfgs else width),
                featmap_strides=tuple(first.get("featmap_strides",
                                                head.anchor_strides)))
        self.frm = frm

    def refined_anchors(self, bbox_preds):
        """Per level [B, H, W, 5]: the first anchor of each cell decoded
        from the first stage's detached deltas."""
        head = self.bbox_head
        outs = []
        for lvl, reg in enumerate(bbox_preds):
            b, h, w, _ = reg.shape
            na = head.num_anchors
            anchors = head.anchors(lvl, (h, w), reg.device)
            decoded = B.delta2bbox_rotated(
                anchors[None], reg.detach().float().reshape(b, h * w * na, 5),
                head.target_means, head.target_stds)
            outs.append(decoded.reshape(b, h, w, na, 5)[:, :, :, 0])
        return outs

    def _refine(self, feats, outs):
        refined = self.refined_anchors(outs[1])
        return refined, self.refine_head(self.frm(feats, refined))

    def loss(self, images, targets, generator=None) -> dict:
        """The first stage's losses and the refine stage's
        (``loss_refine_cls``, ``loss_refine_bbox``); call in train mode.
        Nothing is sampled, so ``generator`` is unused."""
        feats = self.extract_feats(images)
        outs = self.bbox_head(feats, train=True)
        losses = self.bbox_head.loss(outs, targets)
        refined, (r_cls, r_reg) = self._refine(feats, outs)
        b = images.shape[0]
        losses.update(self.refine_head.loss(
            r_cls, r_reg, [r.reshape(b, -1, 5) for r in refined], targets))
        return losses

    @torch.inference_mode()
    def predict(self, images, scale_factor: Optional[torch.Tensor] = None):
        """Eval-mode detections: per level the first stage's ``nms_pre``
        best refined boxes by the refine head's best class, the refine
        deltas decoded against them, class-aware rotated NMS; dict of
        polys [B, P, 8], scores [B, P], labels [B, P] (0-based, -1
        padding), valid [B, P], boxes divided by ``scale_factor`` [B]."""
        if scale_factor is None:
            scale_factor = torch.ones(images.shape[0], device=images.device)
        feats = self.extract_feats(images)
        refined, (r_cls, r_reg) = self._refine(
            feats, self.bbox_head(feats, train=False))
        head = self.bbox_head
        c = head.num_classes - 1
        stds = self.refine_head.target_stds
        results = []
        for i in range(images.shape[0]):
            mlvl_boxes, mlvl_scores = [], []
            for lvl in range(len(r_cls)):
                scores = torch.sigmoid(r_cls[lvl][i].reshape(-1, c).float())
                k = min(head.nms_pre, scores.shape[0])
                _, top_i = top_k(scores.amax(1), k)
                mlvl_boxes.append(B.delta2bbox_rotated(
                    refined[lvl][i].reshape(-1, 5)[top_i],
                    r_reg[lvl][i].reshape(-1, 5).float()[top_i],
                    (0.0,) * 5, stds))
                mlvl_scores.append(scores[top_i])
            boxes = torch.cat(mlvl_boxes)
            boxes = torch.cat([boxes[:, :4] / scale_factor[i].clamp(
                min=1e-6), boxes[:, 4:]], 1)
            scores = torch.cat(mlvl_scores)
            scores = torch.cat([scores.new_zeros(scores.shape[0], 1),
                                scores], 1)
            dets, labels, valid = multiclass_nms_rotated_jit(
                boxes, scores, head.score_thr, head.nms_iou_thr,
                pre_nms=min(2000, scores.shape[0] * c),
                max_num=head.max_per_img)
            results.append((B.rotated_box_to_poly(dets[:, :5]), dets[:, 5],
                            labels, valid))
        return {key: torch.stack([r[j] for r in results])
                for j, key in enumerate(("polys", "scores", "labels",
                                         "valid"))}
