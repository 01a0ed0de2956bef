"""Rotated RetinaNet head (counterpart of
``rs_detection_tpu/models/roi_heads/retina_head.py``).

``stacked_convs`` ReLU 3x3 convs on a classification and a regression
branch over every level, then ``retina_cls`` (A x C sigmoid logits, its
bias at the -log 99 prior) and ``retina_reg`` (A x 5 deltas). The anchors
are ``AnchorGeneratorRotatedS2ANet``'s: octave scales x ratios x angles a
position. Training: one target round on the rotated IoU
(``MaxIoUAssigner``, ``PseudoSampler``: every positive and negative
kept), ``DeltaXYWHABBoxCoder`` targets, sigmoid focal loss and smooth L1
over the batch's sum of ``max(num_pos, 1)``, the regression level by
level in the convs' NHWC layout as in JAX. Inference: per level the
``nms_pre`` best positions, decode, class-aware rotated NMS to
``max_per_img`` fixed slots, polygons.

The pieces are S2ANet's (PR 15): the blocked rotated IoU, the dense
assignment, the focal loss and ``ops/nms_rotated.multiclass_nms_rotated_
jit``; cuDNN convs on the NCHW views of NHWC levels. The JAX head reaches
no Pallas kernel. Every top-k is the stable ``ops.nms.top_k``; the JAX
head's ``fast_top_k`` is approximate above 16,384 anchors a level
(ROADMAP.md, Queue 3)."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import top_k
from ...ops.nms_rotated import multiclass_nms_rotated_jit
from ...utils.registry import HEADS
from ..boxes.anchor_generator import AnchorGeneratorRotatedS2ANet
from ..boxes.anchor_target import anchor_target_single
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import DeltaXYWHABBoxCoder
from ..boxes.sampler import PseudoSampler
from ..losses.common import sigmoid_focal_loss, smooth_l1_loss
from ..utils.modules import conv2d


def octave_scales(octave_base_scale=4, scales_per_octave=3):
    return [octave_base_scale * 2 ** (i / scales_per_octave)
            for i in range(scales_per_octave)]


@HEADS.register_module()
class RetinaHead(nn.Module):
    """The JAX head's arguments with its defaults. ``num_classes``
    counts the background (the JDet convention): ``retina_cls`` has
    ``num_classes - 1`` sigmoid outputs an anchor. Layer names are the
    flax ones: ``cls_{i}``, ``reg_{i}``, ``retina_cls``, ``retina_reg``."""

    def __init__(self, num_classes: int = 16, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 octave_base_scale: int = 4, scales_per_octave: int = 3,
                 anchor_angles: Sequence[float] = (0.0,),
                 target_means: Sequence[float] = (0.0,) * 5,
                 target_stds: Sequence[float] = (1.0,) * 5,
                 focal_gamma: float = 2.0, focal_alpha: float = 0.25,
                 smooth_l1_beta: float = 1.0 / 9.0, nms_pre: int = 2000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.1,
                 max_per_img: int = 2000, pos_iou_thr: float = 0.5,
                 neg_iou_thr: float = 0.4, min_pos_iou: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.cls_out_channels = num_classes - 1
        self.feat_channels = feat_channels
        self.stacked_convs = stacked_convs
        self.anchor_strides = tuple(anchor_strides)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.smooth_l1_beta = smooth_l1_beta
        self.nms_pre = nms_pre
        self.score_thr = score_thr
        self.nms_iou_thr = nms_iou_thr
        self.max_per_img = max_per_img
        scales = octave_scales(octave_base_scale, scales_per_octave)
        self.anchor_gens = [AnchorGeneratorRotatedS2ANet(
            s, scales, anchor_ratios, angles=anchor_angles)
            for s in self.anchor_strides]
        self.num_anchors = self.anchor_gens[0].num_base_anchors
        self.coder = DeltaXYWHABBoxCoder(target_means, target_stds)
        self.assigner = MaxIoUAssigner(
            pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
            min_pos_iou=min_pos_iou,
            iou_calculator=dict(type="BboxOverlaps2D_rotated"))
        self.sampler = PseudoSampler()
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_{i}", nn.Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1))
        tower = feat_channels if stacked_convs else in_channels
        self.retina_cls = nn.Conv2d(
            tower, self.num_anchors * self.cls_out_channels, 3, padding=1)
        self.retina_reg = nn.Conv2d(tower, self.num_anchors * 5, 3, padding=1)
        self._anchor_cache = {}

    def init_weights(self, g: torch.Generator) -> None:
        """The JAX head's initializers: N(0, 0.01) convs, zero biases,
        ``retina_cls``'s bias at -log 99 (a prior probability of 0.01)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, 0.01, generator=g)
                    nn.init.zeros_(m.bias)
            nn.init.constant_(self.retina_cls.bias, -math.log(99.0))

    def anchors(self, level: int, size, device):
        """The level's anchors [H * W * A, 5] on ``device``, position-major
        (the NHWC order of the convs' outputs)."""
        key = (level, tuple(size), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.from_numpy(
                self.anchor_gens[level].grid_anchors(
                    tuple(size), self.anchor_strides[level])).to(device)
        return self._anchor_cache[key]

    def _tower(self, branch, x):
        for i in range(self.stacked_convs):
            x = F.relu(conv2d(getattr(self, f"{branch}_{i}"), x))
        return x

    def forward(self, feats, train: bool = False):
        """NHWC levels -> (cls_scores, bbox_preds), per level [N, H, W,
        A * C] and [N, H, W, A * 5], NHWC. ``train`` changes nothing (the
        JAX head's signature)."""
        cls_scores, bbox_preds = [], []
        for f in feats:
            x = f.permute(0, 3, 1, 2)
            cls_scores.append(conv2d(self.retina_cls, self._tower(
                "cls", x)).permute(0, 2, 3, 1))
            bbox_preds.append(conv2d(self.retina_reg, self._tower(
                "reg", x)).permute(0, 2, 3, 1))
        return cls_scores, bbox_preds

    def loss(self, outs, targets):
        """The focal and smooth-L1 losses of ``forward(feats)``. targets:
        "rboxes" [B, G, 5], "gt_mask" [B, G], "labels" [B, G]
        (1-based)."""
        cls_scores, bbox_preds = outs
        gt_obb = targets["rboxes"].float()
        b = gt_obb.shape[0]
        c = self.cls_out_channels
        dev = gt_obb.device
        sizes = [tuple(p.shape[1:3]) for p in cls_scores]
        anchors = torch.cat([self.anchors(i, hw, dev)
                             for i, hw in enumerate(sizes)])
        res = anchor_target_single(
            anchors, torch.ones(anchors.shape[0], dtype=torch.bool,
                                device=dev),
            gt_obb, targets["gt_mask"].bool(), targets["labels"],
            self.assigner, self.sampler, self.coder.encode, None)
        num_total = res.num_pos.clamp(min=1).sum().float()
        cls = torch.cat([s.reshape(b, -1, c) for s in cls_scores], 1)
        # a background label (0) matches no class: an all-zero row
        classes = torch.arange(1, c + 1, device=dev)
        onehot = (res.labels[..., None] == classes).to(cls.dtype)
        loss_cls = sigmoid_focal_loss(
            cls.reshape(-1, c), onehot.reshape(-1, c),
            res.label_weights.reshape(-1), gamma=self.focal_gamma,
            alpha=self.focal_alpha, avg_factor=num_total)
        loss_bbox = 0.0
        start = 0
        for r in bbox_preds:
            n = r.shape[1] * r.shape[2] * (r.shape[3] // 5)
            sl = slice(start, start + n)
            start += n
            loss_bbox = loss_bbox + smooth_l1_loss(
                r.float(), res.bbox_targets[:, sl].reshape(r.shape),
                res.bbox_weights[:, sl].reshape(r.shape),
                beta=self.smooth_l1_beta, avg_factor=num_total)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def candidates(self, outs, i: int, scale_factor):
        """Image ``i``'s NMS input: per level the ``nms_pre`` best anchors
        by their best class, decoded and divided by ``scale_factor`` (a
        scalar tensor) -> (boxes [K, 5], scores [K, C + 1], the
        background column first as the sigmoid heads lay it out)."""
        cls_scores, bbox_preds = outs
        c = self.cls_out_channels
        mlvl_boxes, mlvl_scores = [], []
        for lvl, (cls, reg) in enumerate(zip(cls_scores, bbox_preds)):
            scores = torch.sigmoid(cls[i].reshape(-1, c).float())
            anchors = self.anchors(lvl, cls.shape[1:3], cls.device)
            k = min(self.nms_pre, scores.shape[0])
            _, top_i = top_k(scores.amax(1), k)
            mlvl_boxes.append(B.delta2bbox_rotated(
                anchors[top_i], reg[i].reshape(-1, 5).float()[top_i],
                self.target_means, self.target_stds))
            mlvl_scores.append(scores[top_i])
        boxes = torch.cat(mlvl_boxes)
        boxes = torch.cat([boxes[:, :4] / scale_factor.clamp(min=1e-6),
                           boxes[:, 4:]], 1)
        scores = torch.cat(mlvl_scores)
        return boxes, torch.cat([scores.new_zeros(scores.shape[0], 1),
                                 scores], 1)

    def get_bboxes(self, outs, scale_factor):
        """Detections of ``forward(feats)`` a tile: dict of polys [B, P,
        8], scores [B, P], labels [B, P] (0-based, -1 padding) and valid
        [B, P], P = ``max_per_img``, by descending score. Boxes are
        divided by ``scale_factor`` [B]."""
        results = []
        for i in range(outs[0][0].shape[0]):
            boxes, scores = self.candidates(outs, i, scale_factor[i])
            dets, labels, valid = multiclass_nms_rotated_jit(
                boxes, scores, self.score_thr, self.nms_iou_thr,
                pre_nms=min(2000, scores.shape[0] * self.cls_out_channels),
                max_num=self.max_per_img)
            results.append((B.rotated_box_to_poly(dets[:, :5]), dets[:, 5],
                            labels, valid))
        return {key: torch.stack([r[j] for r in results])
                for j, key in enumerate(("polys", "scores", "labels",
                                         "valid"))}
