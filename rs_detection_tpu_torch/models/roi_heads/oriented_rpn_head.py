"""Oriented RPN head (counterpart of
``rs_detection_tpu/models/roi_heads/oriented_rpn_head.py``): 3x3 conv +
1x1 cls (sigmoid, one channel per anchor) + 1x1 reg (6-dim midpoint
offsets); the training loss (max-IoU assignment on the gt hbbs, random
sampling, midpoint-offset targets of the gt obbs, BCE + SmoothL1); and
proposal generation with per-level top-k, a global pre-NMS cap,
midpoint-offset decode, hbb NMS with the per-level coordinate offset,
and the top ``nms_post`` as fixed-shape proposals with a valid mask.
Batched over images instead of vmapped."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import greedy_suppress_mask, overlap_gt_mask_hbb, top_k
from ...parallel import dist
from ...utils.registry import HEADS
from ..boxes.anchor_generator import AnchorGenerator
from ..boxes.anchor_target import anchor_target_single
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import MidpointOffsetCoder
from ..boxes.sampler import RandomSampler
from ..losses.common import binary_cross_entropy, smooth_l1_loss
from ..networks.compat import section_kwargs
from ..utils.modules import conv2d, maybe_int8_conv2d


def _take(x, idx):
    """x [B, N, D], idx [B, K] -> [B, K, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


@HEADS.register_module()
class OrientedRPNHead(nn.Module):
    """The JAX head's arguments with its defaults. ``anchor_generator``,
    ``bbox_coder``, ``assigner`` and ``sampler``: ``AnchorGenerator``,
    ``MidpointOffsetCoder``, ``MaxIoUAssigner`` and ``RandomSampler``
    kwargs (a ``type`` key is dropped, as in the JAX head); the JAX
    head's defaults when None. Boxes are kept when w and h exceed
    ``min_bbox_size`` (all of them when it is negative); anchors take
    part in training inside the image plus ``allowed_border``.
    ``int8=True`` serves the 3x3 tower conv through ``ops.quant``."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_classes: int = 1, reg_dim: int = 6,
                 min_bbox_size: float = 0.0, nms_thresh: float = 0.8,
                 nms_pre: int = 2000, nms_post: int = 2000,
                 pre_nms_cap: int = 4096, pos_weight: float = -1.0,
                 allowed_border: int = 0, anchor_generator=None,
                 bbox_coder=None, assigner=None, sampler=None,
                 loss_cls_weight: float = 1.0, loss_bbox_weight: float = 1.0,
                 smooth_l1_beta: float = 1.0 / 9.0, int8: bool = False):
        super().__init__()
        if num_classes != 1 or reg_dim != 6:
            raise NotImplementedError(
                f"OrientedRPNHead: num_classes={num_classes}, reg_dim="
                f"{reg_dim}; the port scores one class and regresses the "
                f"6 midpoint offsets")
        self.int8 = int8  # serve the 3x3 tower conv through int8_conv
        self.reg_dim = reg_dim
        self.min_bbox_size = min_bbox_size
        self.nms_thresh = nms_thresh
        self.nms_pre = nms_pre
        self.nms_post = nms_post
        self.pre_nms_cap = pre_nms_cap
        self.pos_weight = pos_weight
        self.allowed_border = allowed_border
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.smooth_l1_beta = smooth_l1_beta
        self.anchor_gen = AnchorGenerator(**section_kwargs(
            anchor_generator, dict(scales=[8], ratios=[0.5, 1.0, 2.0],
                                   strides=[4, 8, 16, 32, 64])))
        self.coder = MidpointOffsetCoder(**section_kwargs(
            bbox_coder, dict(target_means=[0.0] * 6,
                             target_stds=[1.0, 1.0, 1.0, 1.0, 0.5, 0.5])))
        self.assigner = MaxIoUAssigner(**section_kwargs(
            assigner, dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                           match_low_quality=True)))
        self.sampler = RandomSampler(**section_kwargs(
            sampler, dict(num=256, pos_fraction=0.5)))
        self.num_anchors = self.anchor_gen.num_base_anchors[0]
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, self.num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels,
                                 self.num_anchors * self.reg_dim, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per-level (cls [B, H, W, A], reg [B, H, W, A*6]), NHWC."""
        cls_scores, bbox_preds = [], []
        for f in feats:
            x = F.relu(maybe_int8_conv2d(
                self.rpn_conv, f.permute(0, 3, 1, 2),
                self.int8 and not self.training))
            cls_scores.append(conv2d(self.rpn_cls, x).permute(0, 2, 3, 1))
            bbox_preds.append(conv2d(self.rpn_reg, x).permute(0, 2, 3, 1))
        return cls_scores, bbox_preds

    def loss(self, cls_scores, bbox_preds, targets, generator):
        """Training losses of the per-level outputs of ``forward``.

        targets: "rboxes" [B, G, 5] in the data's angle convention (the
        sign flip to the OBB convention happens here, as in the JAX
        head), "gt_mask" [B, G], "img_hw" [B, 2]. ``generator`` drives
        the sampler. Both losses average over the sampled anchors of the
        batch, sum(max(num_pos, 1) + max(num_neg, 1)), and run in the
        conv's NHWC layout."""
        sizes = [tuple(c.shape[1:3]) for c in cls_scores]
        dev = cls_scores[0].device
        anchors = torch.from_numpy(
            np.concatenate(self.anchor_gen.grid_anchors(sizes))).to(dev)
        s0 = self.anchor_gen.strides[0]
        valid = torch.from_numpy(np.concatenate(self.anchor_gen.valid_flags(
            sizes, (sizes[0][0] * s0, sizes[0][1] * s0)))).to(dev)
        rboxes = targets["rboxes"].float()
        gt_obb = torch.cat([rboxes[..., :4], -rboxes[..., 4:]], dim=-1)
        # one border for the whole (global) batch, as in JAX
        img_h, img_w = dist.global_max(targets["img_hw"].max(0).values)
        border = self.allowed_border
        inside = (valid & (anchors[:, 0] >= -border)
                  & (anchors[:, 1] >= -border)
                  & (anchors[:, 2] < img_w + border)
                  & (anchors[:, 3] < img_h + border))
        res = anchor_target_single(
            anchors, inside, B.obb2hbb(gt_obb), targets["gt_mask"], None,
            self.assigner, self.sampler, self.coder.encode, generator,
            pos_weight=self.pos_weight, gt_bboxes_encode=gt_obb)
        num_total = (res.num_pos.clamp(min=1)
                     + res.num_neg.clamp(min=1)).sum()

        # the anchors' flat order (h, w, a) is the NHWC conv output's,
        # so the targets are reshaped to the predictions, not the reverse
        loss_cls, loss_bbox = 0.0, 0.0
        start = 0
        for (h, w), cls, reg in zip(sizes, cls_scores, bbox_preds):
            b = cls.shape[0]
            sl = slice(start, start + h * w * self.num_anchors)
            start = sl.stop
            nhwc = reg.shape
            loss_cls = loss_cls + self.loss_cls_weight * binary_cross_entropy(
                cls.reshape(b, -1).float(), res.labels[:, sl].float(),
                res.label_weights[:, sl], avg_factor=num_total)
            loss_bbox = loss_bbox + self.loss_bbox_weight * smooth_l1_loss(
                reg.float(), res.bbox_targets[:, sl].reshape(nhwc),
                res.bbox_weights[:, sl].reshape(nhwc),
                beta=self.smooth_l1_beta, avg_factor=num_total)
        return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)

    def get_proposals(self, cls_scores, bbox_preds):
        """Returns (proposals [B, nms_post, 5] obb, scores [B, nms_post],
        valid [B, nms_post]); f32 and bool. The decode is unclipped, as in
        the JAX head, so the image size is not needed."""
        sizes = [tuple(c.shape[1:3]) for c in cls_scores]
        dev = cls_scores[0].device
        b = cls_scores[0].shape[0]
        na, rd = self.num_anchors, self.reg_dim
        cand_s, cand_d, cand_a, cand_l = [], [], [], []
        for lvl, (anchors, cls, reg) in enumerate(zip(
                self.anchor_gen.grid_anchors(sizes), cls_scores, bbox_preds)):
            scores = torch.sigmoid(cls.reshape(b, -1).float())
            k = min(self.nms_pre, scores.shape[1])
            top_s, top_i = top_k(scores, k)
            # regression rows in the conv's (h, w) x (a, 6) layout, then
            # the chosen anchor's 6 columns
            rows = _take(reg.reshape(b, -1, na * rd), top_i // na).float()
            cols = (top_i % na)[..., None] * rd \
                + torch.arange(rd, device=dev)
            cand_s.append(top_s)
            cand_d.append(torch.gather(rows, 2, cols))
            cand_a.append(torch.from_numpy(anchors).to(dev)[top_i])
            cand_l.append(torch.full((b, k), float(lvl), device=dev))
        scores = torch.cat(cand_s, 1)
        deltas = torch.cat(cand_d, 1)
        anchors = torch.cat(cand_a, 1)
        lvl_ids = torch.cat(cand_l, 1)

        cap = min(self.pre_nms_cap, scores.shape[1])
        scores, sel = top_k(scores, cap)
        deltas = _take(deltas, sel)
        anchors = _take(anchors, sel)
        lvl_ids = torch.gather(lvl_ids, 1, sel)

        proposals = self.coder.decode(anchors, deltas)
        ok = torch.ones_like(scores, dtype=torch.bool)
        if self.min_bbox_size >= 0:
            ok = ((proposals[..., 2] > self.min_bbox_size)
                  & (proposals[..., 3] > self.min_bbox_size))
        # level-offset trick: separate the levels in coordinate space
        hbb = B.obb2hbb(proposals)
        span = hbb.amax(dim=(1, 2)) - hbb.amin(dim=(1, 2))
        hbb = hbb + (lvl_ids * (span[:, None] + 1.0))[..., None]

        neg_inf = torch.tensor(float("-inf"), device=dev)
        order = torch.argsort(-torch.where(ok, scores, neg_inf), dim=1,
                              stable=True)
        over = overlap_gt_mask_hbb(_take(hbb, order), self.nms_thresh)
        keep_sorted = greedy_suppress_mask(over, torch.gather(ok, 1, order))
        keep = torch.zeros_like(ok).scatter(1, order, keep_sorted)

        out_s, out_i = top_k(torch.where(keep, scores, neg_inf),
                             min(self.nms_post, cap))
        out_p = _take(proposals, out_i)
        out_valid = torch.isfinite(out_s)
        if self.nms_post > cap:
            pad = self.nms_post - cap
            out_p = F.pad(out_p, (0, 0, 0, pad))
            out_s = F.pad(out_s, (0, pad), value=float("-inf"))
            out_valid = torch.cat([out_valid, out_valid.new_zeros(b, pad)], 1)
        return out_p, torch.where(out_valid, out_s, 0.0), out_valid
