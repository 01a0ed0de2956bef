"""SSD's multibox head, horizontal boxes (counterpart of
``rs_detection_tpu/models/roi_heads/ssd_head.py``).

Per level a 3x3 ``cls_{i}`` conv (A x C softmax logits, the background
at 0) and a 3x3 ``reg_{i}`` conv (A x 4 deltas) over the
``SSDAnchorGenerator`` anchors. Training: one hbb target round over the
batch (``MaxIoUAssigner`` at 0.5 / 0.5 / 0.0 with the low-quality
rescue, fixed as in JAX whatever the config's ``train_cfg`` says;
``PseudoSampler``; ``DeltaXYWHBBoxCoder``), softmax cross-entropy on the
positives and on the hardest negatives of the whole batch, ranked
together by one stable descending sort, ``neg_pos_ratio`` x the batch's
positives of them; smooth L1 with beta 1; both over the batch's
positives. Inference: softmax without the background, the ``nms_pre``
best anchors by their best class, decode, class-aware greedy NMS at
``nms_iou_thr`` (the Jacobi fixpoint of ``ops.nms``), the
``max_per_img`` best, polygons. As in JAX, ``get_bboxes`` ignores the
scale factor; its labels are 0-based (-1 for an empty slot), as every
other single-stage head's, where the JAX head's are 1-based (ROADMAP.md,
"Known inexact spots"). The JAX head reaches no Pallas kernel, and
neither does this one."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import bbox_overlaps_hbb, greedy_suppress_mask, top_k
from ...utils.registry import HEADS
from ..boxes.anchor_generator import SSDAnchorGenerator
from ..boxes.anchor_target import anchor_target_single
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import DeltaXYWHBBoxCoder
from ..boxes.sampler import PseudoSampler
from ..losses.common import smooth_l1_loss
from ..utils.modules import conv2d


@HEADS.register_module()
class SSDHead(nn.Module):
    """The JAX head's fields with its defaults. ``num_classes`` counts
    the background; ``in_channels`` are the levels' widths (the flax
    convs infer them)."""

    def __init__(self, num_classes: int = 81,
                 in_channels: Sequence[int] = (512, 1024, 512, 256, 256,
                                               256),
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 100, 300),
                 basesize_ratio_range: Sequence[float] = (0.15, 0.9),
                 anchor_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
                 input_size: int = 300,
                 target_means: Sequence[float] = (0.0,) * 4,
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 neg_pos_ratio: int = 3, nms_pre: int = 1000,
                 score_thr: float = 0.02, nms_iou_thr: float = 0.45,
                 max_per_img: int = 200):
        super().__init__()
        self.num_classes = num_classes
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.neg_pos_ratio = neg_pos_ratio
        self.nms_pre = nms_pre
        self.score_thr = score_thr
        self.nms_iou_thr = nms_iou_thr
        self.max_per_img = max_per_img
        self.anchor_gen = SSDAnchorGenerator(
            strides=list(anchor_strides),
            ratios=[list(r) for r in anchor_ratios],
            basesize_ratio_range=tuple(basesize_ratio_range),
            input_size=input_size)
        self.coder = DeltaXYWHBBoxCoder(target_means, target_stds)
        self.assigner = MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.5,
                                       min_pos_iou=0.0,
                                       match_low_quality=True)
        self.sampler = PseudoSampler()
        for i, n in enumerate(self.anchor_gen.num_base_anchors):
            self.add_module(f"cls_{i}", nn.Conv2d(
                in_channels[i], n * num_classes, 3, padding=1))
            self.add_module(f"reg_{i}", nn.Conv2d(
                in_channels[i], n * 4, 3, padding=1))
        self._anchor_cache = {}

    def init_weights(self, g: torch.Generator) -> None:
        """The JAX head's initializers: N(0, 0.01) convs, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, 0.01, generator=g)
                    nn.init.zeros_(m.bias)

    def anchors(self, sizes, device):
        """Every level's anchors [A, 4] on ``device``, level by level,
        position-major (the NHWC order of the convs' outputs)."""
        key = (tuple(tuple(s) for s in sizes), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.cat([
                torch.from_numpy(a) for a in
                self.anchor_gen.grid_anchors(sizes)]).to(device)
        return self._anchor_cache[key]

    def forward(self, feats, train: bool = False):
        """NHWC levels -> (cls_scores, bbox_preds), per level [N, H, W,
        A * C] and [N, H, W, A * 4], NHWC. ``train`` changes nothing."""
        cls_scores, bbox_preds = [], []
        for i, f in enumerate(feats):
            x = f.permute(0, 3, 1, 2)
            cls_scores.append(conv2d(getattr(self, f"cls_{i}"), x)
                              .permute(0, 2, 3, 1))
            bbox_preds.append(conv2d(getattr(self, f"reg_{i}"), x)
                              .permute(0, 2, 3, 1))
        return cls_scores, bbox_preds

    def targets(self, anchors, targets):
        """The target round: ``anchor_target_single`` over the batch's
        hbbs, every anchor inside."""
        return anchor_target_single(
            anchors, torch.ones(anchors.shape[0], dtype=torch.bool,
                                device=anchors.device),
            targets["hboxes"].float(), targets["gt_mask"].bool(),
            targets["labels"], self.assigner, self.sampler,
            self.coder.encode, None)

    @torch.no_grad()
    def hard_negatives(self, ce, pos, label_weights, num_pos):
        """[B, A] bool: the ``neg_pos_ratio * num_pos`` negatives of the
        whole batch with the largest cross-entropy ``ce``, ranked by one
        stable descending sort (ties to the lower flat index, as the JAX
        ``argsort`` of the negated losses)."""
        neg_ce = torch.where(pos | (label_weights == 0), -torch.inf, ce)
        flat = neg_ce.reshape(-1)
        order = torch.sort(flat, descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(flat.numel(), device=flat.device)
        budget = (self.neg_pos_ratio * num_pos).long()
        return (rank < budget).reshape(ce.shape) & torch.isfinite(neg_ce)

    def loss(self, outs, targets):
        """The mined softmax cross-entropy and the smooth-L1 loss of
        ``forward(feats)``. targets: "hboxes" [B, G, 4], "gt_mask" [B, G],
        "labels" [B, G] (1-based)."""
        cls_scores, bbox_preds = outs
        b = cls_scores[0].shape[0]
        anchors = self.anchors([c.shape[1:3] for c in cls_scores],
                               cls_scores[0].device)
        res = self.targets(anchors, targets)
        cls = torch.cat([c.reshape(b, -1, self.num_classes)
                         for c in cls_scores], 1).float()
        reg = torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], 1).float()
        pos = res.labels > 0
        num_pos = pos.sum().clamp(min=1).float()
        ce = -F.log_softmax(cls, dim=-1).gather(
            -1, res.labels[..., None])[..., 0]
        neg = self.hard_negatives(ce.detach(), pos, res.label_weights,
                                  num_pos)
        loss_cls = (torch.where(pos, ce, 0.0).sum()
                    + torch.where(neg, ce, 0.0).sum()) / num_pos
        loss_bbox = smooth_l1_loss(reg, res.bbox_targets, res.bbox_weights,
                                   beta=1.0, avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)

    def nms(self, boxes, scores):
        """Class-aware greedy NMS of one image's decoded candidates
        (boxes [K, 4], softmax scores [K, C - 1]) -> (the ``max_per_img``
        best kept (score, index) slots, their best class, 0-based): -inf
        scores mark empty slots."""
        lab = scores.argmax(1)
        best = scores.amax(1)
        ok = best > self.score_thr
        order = torch.sort(torch.where(ok, best, -torch.inf),
                           descending=True, stable=True).indices
        ob, ol = boxes[order], lab[order]
        over = torch.where(ol[:, None] == ol[None, :],
                           bbox_overlaps_hbb(ob, ob), 0.0) > self.nms_iou_thr
        keep = torch.zeros_like(ok)
        keep[order] = greedy_suppress_mask(over, ok[order])
        out_s, sel = top_k(torch.where(keep, best, -torch.inf),
                           min(self.max_per_img, boxes.shape[0]))
        return out_s, sel, lab

    def get_bboxes(self, outs, scale_factor=None):
        """Detections of ``forward(feats)`` an image: dict of polys [B, P,
        8], scores [B, P], labels [B, P] (0-based, -1 for an empty slot)
        and valid [B, P], P = ``min(max_per_img, nms_pre)``, by descending
        score. ``scale_factor`` is ignored, as in JAX."""
        cls_scores, bbox_preds = outs
        anchors = self.anchors([c.shape[1:3] for c in cls_scores],
                               cls_scores[0].device)
        results = []
        for i in range(cls_scores[0].shape[0]):
            cls = torch.cat([c[i].reshape(-1, self.num_classes)
                             for c in cls_scores]).float()
            reg = torch.cat([r[i].reshape(-1, 4) for r in bbox_preds]).float()
            scores = torch.softmax(cls, -1)[:, 1:]
            _, top_i = top_k(scores.amax(1), min(self.nms_pre,
                                                 scores.shape[0]))
            boxes = B.delta2bbox(anchors[top_i], reg[top_i],
                                 self.target_means, self.target_stds)
            out_s, sel, lab = self.nms(boxes, scores[top_i])
            valid = torch.isfinite(out_s)
            results.append((B.hbb2poly(boxes[sel]),
                            torch.where(valid, out_s, 0.0),
                            torch.where(valid, lab[sel], -1), valid))
        return {key: torch.stack([r[j] for r in results])
                for j, key in enumerate(("polys", "scores", "labels",
                                         "valid"))}
