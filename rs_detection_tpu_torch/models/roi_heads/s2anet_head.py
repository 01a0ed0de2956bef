"""S2ANet head (counterpart of
``rs_detection_tpu/models/roi_heads/s2anet_head.py``): FAM -> AlignConv ->
ORConv -> ODM.

The feature alignment module (FAM) regresses one rotated box a position
from the level's square anchor and, in training, scores it; the decoded
boxes (``wh_ratio_clip=1e-6``) are the refined anchors. ``AlignConv``
samples the level at each refined anchor's rotated 3x3 grid through the
deformable convolution (offsets detached). ``ORConv2d`` rotates one
filter bank to 8 orientations (the Active Rotating Filter); the ODM
regresses from its output and classifies from its rotation-invariant
pooling. Training: two anchor-target rounds (FAM on the square anchors,
ODM on each image's refined anchors), rotated max-IoU assignment, every
positive and negative kept, focal and smooth-L1 losses over the batch's
sum of ``max(num_pos, 1)``. Inference: per level the ``nms_pre`` best
positions, decode, class-aware rotated NMS to ``max_per_img`` fixed
slots, polygons.

Plain PyTorch on cuDNN convolutions: the JAX head reaches no Pallas
kernel. Features arrive NHWC from the FPN; the convs run on their NCHW
views (channels_last memory). Every top-k is the stable ``ops.nms.
top_k``; the JAX head's ``fast_top_k`` is approximate above 16,384
positions a level (ROADMAP.md, Queue 3). The train-only FAM classifier
(``fam_cls_*``) is built always, so that the JAX tree (whose init runs
the train branch) carries over name for name.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.deform_conv import deform_conv2d
from ...ops.nms import top_k
from ...ops.nms_rotated import multiclass_nms_rotated_jit
from ...ops.orn import (active_rotating_filter, arf_gather_indices,
                        rotation_invariant_pooling)
from ...utils.registry import HEADS
from ..boxes.anchor_generator import AnchorGeneratorRotatedS2ANet
from ..boxes.anchor_target import anchor_target_single
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import DeltaXYWHABBoxCoder
from ..boxes.sampler import PseudoSampler
from ..losses.common import sigmoid_focal_loss, smooth_l1_loss
from ..utils.modules import conv2d


def bias_init_with_prob(p: float) -> float:
    return float(-np.log((1 - p) / p))


class AlignConv(nn.Module):
    """Anchor-guided deformable 3x3 (reference ``s2anet_head.py:657-723``):
    tap (i, j) of position (y, x) samples at the refined anchor's centre
    plus its rotated (w / k, h / k) grid step, in the level's pixels.
    ``weight`` is the OIHW form of the flax ``kernel``."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(
            feat_channels, in_channels, kernel_size, kernel_size))

    def offsets(self, refine_anchors, stride: float):
        """[N, H, W, 5] image-frame anchors -> [N, H, W, 2 * K * K]
        (dy, dx) deformable offsets, taps row-major (y outer)."""
        n, h, w, _ = refine_anchors.shape
        k = self.kernel_size
        pad = (k - 1) // 2
        f32 = dict(dtype=torch.float32, device=refine_anchors.device)
        idx = torch.arange(-pad, pad + 1, **f32)
        yy = idx.repeat_interleave(k)
        xx = idx.repeat(k)
        x_conv = torch.arange(w, **f32)[:, None] + xx          # [W, K*K]
        y_conv = torch.arange(h, **f32)[:, None] + yy          # [H, K*K]
        a = refine_anchors.float()
        ax, ay = a[..., 0] / stride, a[..., 1] / stride
        aw, ah = a[..., 2] / stride, a[..., 3] / stride
        cos, sin = torch.cos(a[..., 4]), torch.sin(a[..., 4])
        px = (aw / k)[..., None] * xx
        py = (ah / k)[..., None] * yy
        x_anchor = cos[..., None] * px - sin[..., None] * py + ax[..., None]
        y_anchor = sin[..., None] * px + cos[..., None] * py + ay[..., None]
        off_x = x_anchor - x_conv
        off_y = y_anchor - y_conv[:, None, :]
        return torch.stack([off_y, off_x], dim=-1).reshape(n, h, w, -1)

    def forward(self, x, refine_anchors, stride: float):
        """x [N, H, W, C] -> ReLU(deformable conv) [N, H, W, feat], NHWC."""
        k = self.kernel_size
        off = self.offsets(refine_anchors, stride).detach()
        return F.relu(deform_conv2d(x, off.to(x.dtype), self.weight,
                                    kernel_size=k, padding=(k - 1) // 2))


class ORConv2d(nn.Module):
    """Active-rotating-filter conv (reference ``orn.py:620``): the
    [Cout, Cin / nOr, nOr * k * k] ``weight`` (the flax kernel's layout,
    carried as it is) rotated to ``n_rotation`` copies, o-major, then a
    3x3 conv at padding 1. NCHW in and out."""

    def __init__(self, in_channels: int, out_channels: int,
                 n_orientation: int = 1, n_rotation: int = 8,
                 kernel_size: int = 3):
        super().__init__()
        self.kernel_size = kernel_size
        cin = in_channels // n_orientation
        self.weight = nn.Parameter(torch.empty(
            out_channels, cin, n_orientation * kernel_size * kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels * n_rotation))
        self.register_buffer("gather_idx", torch.from_numpy(
            arf_gather_indices(n_orientation, n_rotation, kernel_size)),
            persistent=False)
        self.init_std = math.sqrt(2.0 / (cin * n_orientation
                                         * kernel_size * kernel_size))

    def rotated_weight(self):
        k = self.kernel_size
        rot = active_rotating_filter(self.weight, self.gather_idx)
        return rot.reshape(rot.shape[0], -1, k, k)

    def forward(self, x):
        return F.conv2d(x, self.rotated_weight().to(x.dtype),
                        self.bias.to(x.dtype), padding=1)


@HEADS.register_module()
class S2ANetHead(nn.Module):
    """The JAX head's arguments with its defaults. ``num_classes``
    counts the background (the JDet convention): the classifiers have
    ``num_classes - 1`` sigmoid outputs."""

    def __init__(self, num_classes: int = 16, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 2,
                 with_orconv: bool = True,
                 anchor_scales: Sequence[float] = (4,),
                 anchor_ratios: Sequence[float] = (1.0,),
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
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
        self.with_orconv = with_orconv
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
        self.coder = DeltaXYWHABBoxCoder(target_means, target_stds)
        self.assigner = MaxIoUAssigner(
            pos_iou_thr=pos_iou_thr, neg_iou_thr=neg_iou_thr,
            min_pos_iou=min_pos_iou,
            iou_calculator=dict(type="BboxOverlaps2D_rotated"))
        self.sampler = PseudoSampler()
        self.anchor_gens = [AnchorGeneratorRotatedS2ANet(
            s, anchor_scales, anchor_ratios) for s in self.anchor_strides]
        fc = feat_channels
        for branch in ("fam_reg", "fam_cls"):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_{i}", nn.Conv2d(
                    in_channels if i == 0 else fc, fc, 3, padding=1))
        self.fam_reg_out = nn.Conv2d(fc, 5, 1)
        self.fam_cls_out = nn.Conv2d(fc, self.cls_out_channels, 1)
        self.align_conv = AlignConv(in_channels, fc, 3)
        if with_orconv:
            self.or_conv = ORConv2d(fc, fc // 8, n_orientation=1,
                                    n_rotation=8)
            cls_in = fc // 8
        else:
            self.or_conv_plain = nn.Conv2d(fc, fc, 3, padding=1)
            cls_in = fc
        for branch, cin in (("odm_reg", fc), ("odm_cls", cls_in)):
            for i in range(stacked_convs):
                self.add_module(f"{branch}_{i}", nn.Conv2d(
                    cin if i == 0 else fc, fc, 3, padding=1))
        self.odm_cls_out = nn.Conv2d(fc, self.cls_out_channels, 3, padding=1)
        self.odm_reg_out = nn.Conv2d(fc, 5, 3, padding=1)
        self.stacked_convs = stacked_convs
        self._anchor_cache = {}

    def init_weights(self, g: torch.Generator) -> None:
        """The JAX head's initializers: N(0, 0.01) convs and AlignConv, the
        ARF weight N(0, sqrt(2 / fan_in)), zero biases, the classifiers'
        biases at a prior probability of 0.01."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, 0.01, generator=g)
                    nn.init.zeros_(m.bias)
            self.align_conv.weight.normal_(0.0, 0.01, generator=g)
            if self.with_orconv:
                self.or_conv.weight.normal_(0.0, self.or_conv.init_std,
                                            generator=g)
                nn.init.zeros_(self.or_conv.bias)
            for m in (self.fam_cls_out, self.odm_cls_out):
                nn.init.constant_(m.bias, bias_init_with_prob(0.01))

    def _tower(self, branch, x):
        for i in range(self.stacked_convs):
            x = F.relu(conv2d(getattr(self, f"{branch}_{i}"), x))
        return x

    def anchors(self, level: int, size, device):
        """The level's square anchors [H * W, 5] on ``device``."""
        key = (level, tuple(size), str(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.from_numpy(
                self.anchor_gens[level].grid_anchors(
                    tuple(size), self.anchor_strides[level])).to(device)
        return self._anchor_cache[key]

    def forward_single(self, x, level: int, train: bool):
        """One NHWC level -> (fam_cls or None, fam_reg, refined anchors,
        odm_cls, odm_reg), each [N, H, W, .]."""
        n, h, w, _ = x.shape
        nchw = x.permute(0, 3, 1, 2)
        fam_bbox_pred = conv2d(self.fam_reg_out, self._tower("fam_reg", nchw))
        fam_cls_score = None
        if train:
            fam_cls_score = conv2d(self.fam_cls_out,
                                   self._tower("fam_cls", nchw)) \
                .permute(0, 2, 3, 1)
        fam_bbox_pred = fam_bbox_pred.permute(0, 2, 3, 1)
        deltas = fam_bbox_pred.detach().reshape(n, -1, 5).float()
        refined = B.delta2bbox_rotated(
            self.anchors(level, (h, w), x.device)[None], deltas,
            self.target_means, self.target_stds, wh_ratio_clip=1e-6)
        refine_anchor = refined.reshape(n, h, w, 5)
        align = self.align_conv(x, refine_anchor, self.anchor_strides[level])
        align = align.permute(0, 3, 1, 2)
        if self.with_orconv:
            or_feat = self.or_conv(align)
            cls_feat = rotation_invariant_pooling(
                or_feat.permute(0, 2, 3, 1), 8).permute(0, 3, 1, 2)
        else:
            or_feat = cls_feat = conv2d(self.or_conv_plain, align)
        odm_cls_score = conv2d(self.odm_cls_out,
                               self._tower("odm_cls", cls_feat))
        odm_bbox_pred = conv2d(self.odm_reg_out,
                               self._tower("odm_reg", or_feat))
        return (fam_cls_score, fam_bbox_pred, refine_anchor,
                odm_cls_score.permute(0, 2, 3, 1),
                odm_bbox_pred.permute(0, 2, 3, 1))

    def forward(self, feats, train: bool = False):
        """Per-level outputs, grouped as the JAX head returns them: a
        tuple of five tuples (one entry a level)."""
        outs = [self.forward_single(f, i, train) for i, f in enumerate(feats)]
        return tuple(zip(*outs))

    # ------------------------------------------------------------------

    def loss(self, outs, targets):
        """The FAM and ODM losses of ``forward(feats, train=True)``.
        targets: "rboxes" [B, G, 5], "gt_mask" [B, G], "labels" [B, G]
        (1-based)."""
        (fam_cls_scores, fam_bbox_preds, refine_anchors, odm_cls_scores,
         odm_bbox_preds) = outs
        gt_obb = targets["rboxes"].float()
        gt_mask = targets["gt_mask"].bool()
        gt_labels = targets["labels"]
        b = gt_obb.shape[0]
        c = self.cls_out_channels
        dev = gt_obb.device
        init_anchors = torch.cat([
            self.anchors(i, p.shape[1:3], dev)
            for i, p in enumerate(fam_bbox_preds)])
        refined = torch.cat([r.reshape(b, -1, 5) for r in refine_anchors], 1)
        classes = torch.arange(1, c + 1, device=dev)
        losses = {}
        for branch, anchors, cls_scores, bbox_preds in (
                ("fam", init_anchors, fam_cls_scores, fam_bbox_preds),
                ("odm", refined, odm_cls_scores, odm_bbox_preds)):
            inside = torch.ones(anchors.shape[-2], dtype=torch.bool,
                                device=dev)
            res = anchor_target_single(
                anchors, inside, gt_obb, gt_mask, gt_labels, self.assigner,
                self.sampler, self.coder.encode, None)
            num_total = res.num_pos.clamp(min=1).sum().float()
            cls = torch.cat([s.reshape(b, -1, c) for s in cls_scores], 1)
            reg = torch.cat([r.reshape(b, -1, 5) for r in bbox_preds], 1)
            # a background label (0) matches no class: an all-zero row
            onehot = (res.labels[..., None] == classes).to(cls.dtype)
            losses[f"loss_{branch}_cls"] = sigmoid_focal_loss(
                cls.reshape(-1, c), onehot.reshape(-1, c),
                res.label_weights.reshape(-1), gamma=self.focal_gamma,
                alpha=self.focal_alpha, avg_factor=num_total)
            losses[f"loss_{branch}_bbox"] = smooth_l1_loss(
                reg.reshape(-1, 5), res.bbox_targets.reshape(-1, 5),
                res.bbox_weights.reshape(-1, 5), beta=self.smooth_l1_beta,
                avg_factor=num_total)
        return losses

    # ------------------------------------------------------------------

    def candidates(self, outs, i: int, scale_factor):
        """Image ``i``'s NMS input: per level the ``nms_pre`` best
        positions by their best class, decoded from the refined anchors
        and divided by ``scale_factor`` (a scalar tensor) -> (boxes [K,
        5], scores [K, C + 1], the background column first as the sigmoid
        heads lay it out)."""
        _, _, refine_anchors, odm_cls_scores, odm_bbox_preds = outs
        c = self.cls_out_channels
        mlvl_boxes, mlvl_scores = [], []
        for cls, reg, anchors in zip(odm_cls_scores, odm_bbox_preds,
                                     refine_anchors):
            scores = torch.sigmoid(cls[i].reshape(-1, c).float())
            k = min(self.nms_pre, scores.shape[0])
            _, top_i = top_k(scores.amax(1), k)
            mlvl_boxes.append(B.delta2bbox_rotated(
                anchors[i].reshape(-1, 5)[top_i],
                reg[i].reshape(-1, 5).float()[top_i], self.target_means,
                self.target_stds))
            mlvl_scores.append(scores[top_i])
        boxes = torch.cat(mlvl_boxes)
        sf = scale_factor.clamp(min=1e-6)
        boxes = torch.cat([boxes[:, :4] / sf, boxes[:, 4:]], 1)
        scores = torch.cat(mlvl_scores)
        return boxes, torch.cat([scores.new_zeros(scores.shape[0], 1),
                                 scores], 1)

    def get_bboxes(self, outs, scale_factor):
        """Detections of ``forward(feats)`` a tile: dict of polys [B, P,
        8], scores [B, P], labels [B, P] (0-based, -1 padding) and valid
        [B, P], P = ``max_per_img``, by descending score. Boxes are
        divided by ``scale_factor`` [B]."""
        results = []
        for i in range(outs[3][0].shape[0]):
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
