"""Horizontal RPN head (counterpart of
``rs_detection_tpu/models/roi_heads/rpn_head.py:RPNHead``), the first
stage of RoI-Transformer and FasterRCNN-OBB: 3x3 conv + 1x1 sigmoid cls +
1x1 4-dim reg per anchor; training targets by hbb max-IoU assignment,
random sampling and ``GVDeltaXYWHBBoxCoder``; proposals by per-level
top-k, a global pre-NMS cap, hbb decode, hbb NMS with the per-level
coordinate offset, and the top ``nms_post`` as fixed-shape hbbs with a
valid mask. Batched over images instead of vmapped; every top-k and sort
goes through the stable ``ops.nms.top_k`` (ties to the lower index, as
``jax.lax.top_k``), so the card and the CPU order ties alike.
``GlidingRPNHead`` is the same head under Gliding Vertex's name."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import greedy_suppress_mask, overlap_gt_mask_hbb, top_k
from ...utils.registry import HEADS
from ..boxes.anchor_generator import AnchorGenerator
from ..boxes.anchor_target import anchor_target_single
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import GVDeltaXYWHBBoxCoder
from ..boxes.sampler import RandomSampler
from ..losses.common import binary_cross_entropy, smooth_l1_loss
from ..networks.compat import section_kwargs
from ..utils.modules import conv2d
from .oriented_rpn_head import _take


@HEADS.register_module()
class RPNHead(nn.Module):
    """The JAX head's arguments with its defaults. ``anchor_generator``,
    ``assigner`` and ``sampler``: ``AnchorGenerator``,
    ``MaxIoUAssigner`` and ``RandomSampler`` kwargs; the assigner's
    ``iou_calculator`` and ``ignore_iof_thr`` are dropped, as the JAX
    head drops them (hbb IoU, no ignore regions). Anchors take part in
    training inside the image plus ``allowed_border``; proposals are kept
    where w and h exceed ``min_bbox_size``."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 min_bbox_size: float = 0.0, nms_thresh: float = 0.7,
                 nms_pre: int = 2000, nms_post: int = 2000,
                 pre_nms_cap: int = 4096, pos_weight: float = -1.0,
                 allowed_border: int = 0, anchor_generator=None,
                 target_means: Sequence[float] = (0.0,) * 4,
                 target_stds: Sequence[float] = (1.0,) * 4, assigner=None,
                 sampler=None, smooth_l1_beta: float = 1.0 / 9.0):
        super().__init__()
        self.min_bbox_size = min_bbox_size
        self.nms_thresh = nms_thresh
        self.nms_pre = nms_pre
        self.nms_post = nms_post
        self.pre_nms_cap = pre_nms_cap
        self.pos_weight = pos_weight
        self.allowed_border = allowed_border
        self.smooth_l1_beta = smooth_l1_beta
        self.anchor_gen = AnchorGenerator(**section_kwargs(
            anchor_generator, dict(scales=[8], ratios=[0.5, 1.0, 2.0],
                                   strides=[4, 8, 16, 32, 64])))
        self.coder = GVDeltaXYWHBBoxCoder(target_means, target_stds)
        asn = section_kwargs(assigner, dict(
            pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
            match_low_quality=True))
        for k in ("iou_calculator", "ignore_iof_thr"):
            asn.pop(k, None)
        self.assigner = MaxIoUAssigner(**asn)
        self.sampler = RandomSampler(**section_kwargs(
            sampler, dict(num=256, pos_fraction=0.5)))
        self.num_anchors = self.anchor_gen.num_base_anchors[0]
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, self.num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, self.num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per-level (cls [B, H, W, A], reg [B, H, W, A*4]), NHWC."""
        cls_scores, bbox_preds = [], []
        for f in feats:
            x = F.relu(conv2d(self.rpn_conv, f.permute(0, 3, 1, 2)))
            cls_scores.append(conv2d(self.rpn_cls, x).permute(0, 2, 3, 1))
            bbox_preds.append(conv2d(self.rpn_reg, x).permute(0, 2, 3, 1))
        return cls_scores, bbox_preds

    def loss(self, cls_scores, bbox_preds, targets, generator):
        """Training losses of the per-level outputs of ``forward``.

        targets: "hboxes" [B, G, 4], "gt_mask" [B, G], "img_hw" [B, 2].
        ``generator`` drives the sampler. Both losses average over the
        sampled anchors of the batch, sum(max(num_pos, 1) + max(num_neg,
        1)); smooth L1 with ``smooth_l1_beta``."""
        sizes = [tuple(c.shape[1:3]) for c in cls_scores]
        dev = cls_scores[0].device
        anchors = torch.from_numpy(
            np.concatenate(self.anchor_gen.grid_anchors(sizes))).to(dev)
        img_h = targets["img_hw"][:, 0].max()
        img_w = targets["img_hw"][:, 1].max()
        border = self.allowed_border
        inside = ((anchors[:, 0] >= -border) & (anchors[:, 1] >= -border)
                  & (anchors[:, 2] < img_w + border)
                  & (anchors[:, 3] < img_h + border))
        res = anchor_target_single(
            anchors, inside, targets["hboxes"].float(), targets["gt_mask"],
            None, self.assigner, self.sampler, self.coder.encode, generator,
            pos_weight=self.pos_weight)
        num_total = (res.num_pos.clamp(min=1)
                     + res.num_neg.clamp(min=1)).sum()
        # the anchors' flat order (h, w, a) is the NHWC conv output's
        loss_cls, loss_bbox = 0.0, 0.0
        start = 0
        for (h, w), cls, reg in zip(sizes, cls_scores, bbox_preds):
            b = cls.shape[0]
            sl = slice(start, start + h * w * self.num_anchors)
            start = sl.stop
            loss_cls = loss_cls + binary_cross_entropy(
                cls.reshape(b, -1).float(), res.labels[:, sl].float(),
                res.label_weights[:, sl], avg_factor=num_total)
            loss_bbox = loss_bbox + smooth_l1_loss(
                reg.reshape(b, -1, 4).float(), res.bbox_targets[:, sl],
                res.bbox_weights[:, sl], beta=self.smooth_l1_beta,
                avg_factor=num_total)
        return dict(loss_rpn_cls=loss_cls, loss_rpn_bbox=loss_bbox)

    def get_proposals(self, cls_scores, bbox_preds, img_hw=None):
        """Returns (proposals [B, nms_post, 4] hbb, scores [B, nms_post],
        valid [B, nms_post]); f32 and bool. The decode is unclipped, as in
        the JAX head, which takes ``img_hw`` and does not use it."""
        sizes = [tuple(c.shape[1:3]) for c in cls_scores]
        dev = cls_scores[0].device
        b = cls_scores[0].shape[0]
        cand_s, cand_d, cand_a, cand_l = [], [], [], []
        for lvl, (anchors, cls, reg) in enumerate(zip(
                self.anchor_gen.grid_anchors(sizes), cls_scores, bbox_preds)):
            scores = torch.sigmoid(cls.reshape(b, -1).float())
            k = min(self.nms_pre, scores.shape[1])
            top_s, top_i = top_k(scores, k)
            cand_s.append(top_s)
            cand_d.append(_take(reg.reshape(b, -1, 4).float(), top_i))
            cand_a.append(torch.from_numpy(anchors).to(dev)[top_i])
            cand_l.append(torch.full((b, k), float(lvl), device=dev))
        scores = torch.cat(cand_s, 1)
        deltas = torch.cat(cand_d, 1)
        anchors = torch.cat(cand_a, 1)
        lvl_ids = torch.cat(cand_l, 1)

        cap = min(self.pre_nms_cap, scores.shape[1])
        scores, sel = top_k(scores, cap)
        proposals = B.delta2bbox(_take(anchors, sel), _take(deltas, sel),
                                 self.coder.means, self.coder.stds)
        lvl_ids = torch.gather(lvl_ids, 1, sel)
        w = proposals[..., 2] - proposals[..., 0]
        h = proposals[..., 3] - proposals[..., 1]
        ok = (w > self.min_bbox_size) & (h > self.min_bbox_size)
        # level-offset trick: separate the levels in coordinate space
        span = proposals.amax(dim=(1, 2)) - proposals.amin(dim=(1, 2))
        shifted = proposals + (lvl_ids * (span[:, None] + 1.0))[..., None]

        neg_inf = torch.tensor(float("-inf"), device=dev)
        _, order = top_k(torch.where(ok, scores, neg_inf), cap)
        over = overlap_gt_mask_hbb(_take(shifted, order), self.nms_thresh)
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


@HEADS.register_module()
class GlidingRPNHead(RPNHead):
    """The hbb RPN under Gliding Vertex's name (JAX ``rpn_head.py:183``,
    reference ``gliding_rpn_head.py:9``)."""
