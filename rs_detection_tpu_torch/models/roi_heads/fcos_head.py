"""Anchor-free rotated FCOS head (counterpart of
``rs_detection_tpu/models/roi_heads/fcos_head.py``).

Two towers of ``stacked_convs`` 3x3 convs (no bias), each followed by a
32-group GroupNorm with flax's epsilon 1e-6 (torch's default is 1e-5)
and a ReLU, over every level; ``conv_cls`` (sigmoid logits, the bias at
the -log 99 prior), ``conv_reg`` (four edge distances times the level's
learnable ``scales`` entry), ``conv_theta`` (times ``scale_theta_p``) and
``conv_centerness``. With ``norm_on_bbox`` the distances are ReLU'd, and
multiplied by the level's stride in eval only: the loss multiplies them
by the points' strides instead.

Targets are one dense [B, P, G] computation (points rotated into each
box's ``mintheta_obb`` frame, centre sampling, the level's regress range,
the smallest candidate box, ties to the first slot as in JAX). Losses:
sigmoid focal over the points, the poly-IoU loss of the decoded boxes
weighted by the centerness targets, the centerness BCE over the
positives. Inference: per level the ``nms_pre`` best points by
score x centerness (``centerness_factor`` added to the sigmoid
centerness), ``distance2obb``, class-aware rotated NMS with the
centerness as score factor.

Plain PyTorch on every device, cuDNN convs on the NCHW views of NHWC
levels: the JAX head reaches no Pallas kernel. Every top-k is the exact
``ops.nms.top_k``; the JAX head's ``fast_top_k`` is approximate above
16,384 points a level (ROADMAP.md, Queue 3)."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import top_k
from ...ops.nms_rotated import multiclass_nms_rotated_jit
from ...utils.registry import HEADS
from ..losses.common import binary_cross_entropy, sigmoid_focal_loss
from ..losses.poly_iou_loss import poly_iou_loss
from ..utils.modules import conv2d

INF = 1e8


@HEADS.register_module()
class FCOSHead(nn.Module):
    """The JAX head's arguments with its defaults. ``num_classes`` counts
    the foreground classes only. Layer names are the flax ones:
    ``cls_{i}``, ``cls_gn_{i}``, ``reg_{i}``, ``reg_gn_{i}``, ``conv_cls``,
    ``conv_reg``, ``conv_theta``, ``conv_centerness``, ``scales``,
    ``scale_theta_p``."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence[Tuple[float, float]] = (
                     (-1, 64), (64, 128), (128, 256), (256, 512),
                     (512, INF)),
                 center_sampling: bool = True,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = True, scale_theta: bool = True,
                 focal_gamma: float = 2.0, focal_alpha: float = 0.25,
                 nms_pre: int = 2000, score_thr: float = 0.05,
                 nms_iou_thr: float = 0.1, max_per_img: int = 2000,
                 centerness_factor: float = 0.0):
        super().__init__()
        self.num_classes = num_classes
        self.stacked_convs = stacked_convs
        self.strides = tuple(strides)
        self.regress_ranges = tuple(tuple(r) for r in regress_ranges)
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.norm_on_bbox = norm_on_bbox
        self.scale_theta = scale_theta
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.nms_pre = nms_pre
        self.score_thr = score_thr
        self.nms_iou_thr = nms_iou_thr
        self.max_per_img = max_per_img
        self.centerness_factor = centerness_factor
        for branch in ("cls", "reg"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_{i}", nn.Conv2d(
                    in_channels if i == 0 else feat_channels, feat_channels,
                    3, padding=1, bias=False))
                self.add_module(f"{branch}_gn_{i}", nn.GroupNorm(
                    32, feat_channels, eps=1e-6))
        tower = feat_channels if stacked_convs else in_channels
        self.conv_cls = nn.Conv2d(tower, num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(tower, 4, 3, padding=1)
        self.conv_theta = nn.Conv2d(tower, 1, 3, padding=1)
        self.conv_centerness = nn.Conv2d(tower, 1, 3, padding=1)
        self.scales = nn.Parameter(torch.ones(len(self.strides)))
        if scale_theta:
            self.scale_theta_p = nn.Parameter(torch.ones(()))

    def init_weights(self, g: torch.Generator) -> None:
        """The JAX head's initializers: N(0, 0.01) convs, zero biases,
        ``conv_cls``'s bias at -log 99, unit GroupNorms and scales."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, 0.01, generator=g)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
            nn.init.constant_(self.conv_cls.bias, -math.log(99.0))
            nn.init.ones_(self.scales)
            if self.scale_theta:
                nn.init.ones_(self.scale_theta_p)

    def _tower(self, branch, x):
        for i in range(self.stacked_convs):
            gn = getattr(self, f"{branch}_gn_{i}")
            # the native op, as F.group_norm calls it, without its check
            # that refuses one value a group in training: a 1 x 1 level
            # normalizes to the bias there, as flax's GroupNorm does
            x = F.relu(torch.group_norm(
                conv2d(getattr(self, f"{branch}_{i}"), x), gn.num_groups,
                gn.weight, gn.bias, gn.eps, torch.backends.cudnn.enabled))
        return x

    def forward(self, feats, train: bool = False):
        """NHWC levels -> (cls_scores, bbox_preds, theta_preds,
        centernesses), per level NHWC [N, H, W, C], [N, H, W, 4],
        [N, H, W, 1], [N, H, W, 1]."""
        outs = ([], [], [], [])
        for level, f in enumerate(feats):
            x = f.permute(0, 3, 1, 2)
            cls_feat = self._tower("cls", x)
            reg_feat = self._tower("reg", x)
            bbox = conv2d(self.conv_reg, reg_feat) * self.scales[level]
            if self.norm_on_bbox:
                bbox = F.relu(bbox)
                if not train:
                    bbox = bbox * self.strides[level]
            else:
                bbox = torch.exp(bbox)
            theta = conv2d(self.conv_theta, reg_feat)
            if self.scale_theta:
                theta = theta * self.scale_theta_p
            for out, t in zip(outs, (
                    conv2d(self.conv_cls, cls_feat), bbox, theta,
                    conv2d(self.conv_centerness, reg_feat))):
                out.append(t.permute(0, 2, 3, 1))
        return outs

    def points(self, featmap_sizes):
        """Per level the points [H * W, 2] (x, y) at the cells' centres,
        row-major, f32 numpy."""
        pts = []
        for (h, w), s in zip(featmap_sizes, self.strides):
            x = (np.arange(w) * s + s // 2).astype(np.float32)
            y = (np.arange(h) * s + s // 2).astype(np.float32)
            pts.append(np.stack([np.tile(x, h), np.repeat(y, w)], -1))
        return pts

    def targets(self, points, point_strides, regress_ranges, gt_obb,
                gt_mask, gt_labels):
        """Dense targets of a batch: points [P, 2], their strides [P] and
        regress ranges [P, 2]; gt_obb [B, G, 5], gt_mask [B, G], gt_labels
        [B, G] (1-based) -> labels [B, P] (0-based, ``num_classes`` for
        the background) and (left, top, right, bottom, theta) [B, P, 5]."""
        gt = B.mintheta_obb(gt_obb)
        ctr, wh, theta = gt[..., :2], gt[..., 2:4], gt[..., 4]
        areas = torch.where(gt_mask, wh[..., 0] * wh[..., 1], INF)
        c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        off = points[None, :, None, :] - ctr[:, None, :, :]   # [B, P, G, 2]
        ox = c * off[..., 0] + s * off[..., 1]
        oy = -s * off[..., 0] + c * off[..., 1]
        w2 = wh[:, None, :, 0] / 2
        h2 = wh[:, None, :, 1] / 2
        dists = torch.stack([w2 + ox, h2 + oy, w2 - ox, h2 - oy], -1)
        inside = dists.amin(-1) > 0
        if self.center_sampling:
            radius = (point_strides * self.center_sample_radius)[:, None]
            inside = inside & (ox.abs() < radius) & (oy.abs() < radius)
        maxd = dists.amax(-1)
        in_range = ((maxd >= regress_ranges[:, None, 0])
                    & (maxd <= regress_ranges[:, None, 1]))
        cand = torch.where(inside & in_range & gt_mask[:, None],
                           areas[:, None], INF)
        min_area, min_idx = cand.min(-1)
        labels = torch.where(
            min_area < INF, torch.gather(gt_labels.long(), 1, min_idx) - 1,
            self.num_classes)
        sel = torch.gather(dists, 2, min_idx[..., None, None].expand(
            -1, -1, 1, 4))[:, :, 0]
        return labels, torch.cat([sel, torch.gather(theta, 1, min_idx)[
            ..., None]], -1)

    def level_tensors(self, featmap_sizes, device):
        pts_np = self.points(featmap_sizes)
        points = torch.from_numpy(np.concatenate(pts_np, 0)).to(device)
        strides = torch.from_numpy(np.concatenate(
            [np.full(len(p), s, np.float32)
             for p, s in zip(pts_np, self.strides)])).to(device)
        ranges = torch.from_numpy(np.concatenate(
            [np.tile(np.asarray(r, np.float32)[None], (len(p), 1))
             for p, r in zip(pts_np, self.regress_ranges)])).to(device)
        return points, strides, ranges

    def loss(self, outs, targets):
        """The focal, poly-IoU and centerness losses of ``forward(feats,
        train=True)``. targets: "rboxes" [B, G, 5], "gt_mask" [B, G],
        "labels" [B, G] (1-based)."""
        cls_scores, bbox_preds, theta_preds, centernesses = outs
        b = cls_scores[0].shape[0]
        nc = self.num_classes
        dev = cls_scores[0].device
        sizes = [tuple(c.shape[1:3]) for c in cls_scores]
        points, point_strides, ranges = self.level_tensors(sizes, dev)
        labels, bbox_targets = self.targets(
            points, point_strides, ranges, targets["rboxes"].float(),
            targets["gt_mask"].bool(), targets["labels"])
        cls = torch.cat([c.reshape(b, -1, nc) for c in cls_scores], 1)
        reg4 = torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], 1)
        th = torch.cat([t.reshape(b, -1, 1) for t in theta_preds], 1)
        ctr = torch.cat([c.reshape(b, -1) for c in centernesses], 1)
        if self.norm_on_bbox:
            reg4 = reg4 * point_strides[None, :, None]
        reg = torch.cat([reg4, th], -1).float()

        flat_labels = labels.reshape(-1)
        pos = flat_labels < nc
        # counts over the batch, clamped at 1 in the losses (over the
        # global batch under a process group)
        num_pos = pos.sum().float()
        classes = torch.arange(nc, device=dev)
        onehot = (flat_labels[:, None] == classes).to(cls.dtype)
        loss_cls = sigmoid_focal_loss(
            cls.reshape(-1, nc).float(), onehot.float(),
            gamma=self.focal_gamma, alpha=self.focal_alpha,
            avg_factor=num_pos)

        flat_targets = bbox_targets.reshape(-1, 5)
        lr, tb = flat_targets[:, [0, 2]], flat_targets[:, [1, 3]]
        ctr_targets = torch.sqrt(torch.clamp(
            (lr.amin(-1) / lr.amax(-1).clamp(min=1e-6))
            * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6)), min=0))
        ctr_targets = torch.where(pos, ctr_targets, 0.0)
        pts_all = points.repeat(b, 1)
        loss_bbox = poly_iou_loss(
            B.distance2obb(pts_all, reg.reshape(-1, 5)),
            B.distance2obb(pts_all, flat_targets), linear=False,
            weight=ctr_targets, avg_factor=ctr_targets.sum())
        loss_centerness = binary_cross_entropy(
            ctr.reshape(-1).float(), ctr_targets, weight=pos.float(),
            avg_factor=num_pos)
        return dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
                    loss_centerness=loss_centerness)

    def candidates(self, outs, i: int, scale_factor):
        """Image ``i``'s NMS input: per level the ``nms_pre`` best points
        by score x centerness, decoded and divided by ``scale_factor`` (a
        scalar tensor) -> (boxes [K, 5], scores [K, C + 1] with the
        background column first, centerness [K])."""
        cls_scores, bbox_preds, theta_preds, centernesses = outs
        nc = self.num_classes
        pts_np = self.points([tuple(c.shape[1:3]) for c in cls_scores])
        mlvl_boxes, mlvl_scores, mlvl_ctr = [], [], []
        for lvl in range(len(cls_scores)):
            scores = torch.sigmoid(cls_scores[lvl][i].reshape(-1, nc).float())
            ctr = torch.sigmoid(centernesses[lvl][i].reshape(-1).float()) \
                + self.centerness_factor
            reg = torch.cat([bbox_preds[lvl][i].reshape(-1, 4),
                             theta_preds[lvl][i].reshape(-1, 1)], -1).float()
            pts = torch.from_numpy(pts_np[lvl]).to(scores.device)
            k = min(self.nms_pre, scores.shape[0])
            _, top_i = top_k((scores * ctr[:, None]).amax(1), k)
            mlvl_boxes.append(B.distance2obb(pts[top_i], reg[top_i]))
            mlvl_scores.append(scores[top_i])
            mlvl_ctr.append(ctr[top_i])
        boxes = torch.cat(mlvl_boxes)
        boxes = torch.cat([boxes[:, :4] / scale_factor.clamp(min=1e-6),
                           boxes[:, 4:]], 1)
        scores = torch.cat(mlvl_scores)
        return (boxes, torch.cat([scores.new_zeros(scores.shape[0], 1),
                                  scores], 1), torch.cat(mlvl_ctr))

    def get_bboxes(self, outs, scale_factor):
        """Detections of ``forward(feats)`` a tile: dict of polys [B, P,
        8], scores [B, P], labels [B, P] (0-based, -1 padding) and valid
        [B, P], P = ``max_per_img``, by descending score. Boxes are
        divided by ``scale_factor`` [B]."""
        results = []
        for i in range(outs[0][0].shape[0]):
            boxes, scores, ctr = self.candidates(outs, i, scale_factor[i])
            dets, labels, valid = multiclass_nms_rotated_jit(
                boxes, scores, self.score_thr, self.nms_iou_thr,
                pre_nms=min(2000, scores.shape[0] * self.num_classes),
                max_num=self.max_per_img, score_factors=ctr)
            results.append((B.rotated_box_to_poly(dets[:, :5]), dets[:, 5],
                            labels, valid))
        return {key: torch.stack([r[j] for r in results])
                for j, key in enumerate(("polys", "scores", "labels",
                                         "valid"))}
