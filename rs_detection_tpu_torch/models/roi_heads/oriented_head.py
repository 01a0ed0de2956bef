"""Oriented R-CNN second stage (counterpart of
``rs_detection_tpu/models/roi_heads/oriented_head.py``): rotated RoI
features -> 2 shared FCs -> softmax cls (C+1, background last) and a
class-agnostic 5-dim ``OrientedDeltaXYWHTCoder`` regression. Training:
rotated-IoU assignment of the proposals plus the ground truths, random
sampling into a fixed number of roi slots per image, CE + SmoothL1. At
test time decode + rescale only (per-tile NMS is deferred to the
merge)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import top_k
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import OrientedDeltaXYWHTCoder
from ..boxes.sampler import RandomSampler
from ..losses.common import smooth_l1_loss, softmax_cross_entropy
from ..roi_extractors.oriented_single_level import OrientedSingleRoIExtractor
from ..utils.modules import linear


class OrientedHead(nn.Module):
    """``assigner`` and ``sampler``: ``MaxIoUAssigner`` and
    ``RandomSampler`` kwargs, the JAX head's when None. The JAX head's
    defaults that no config changes are constants here: 2 shared FCs,
    class-agnostic regression, coder stds (0.1, 0.1, 0.2, 0.2, 0.1), the
    extractor's 7x7 x 2x2 sampling over strides 4-32 with rois inflated
    by (1.4, 1.2), and positive weight 1."""

    NUM_SHARED_FCS = 2
    REG_DIM = 5
    ASSIGNER = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                    match_low_quality=False,
                    iou_calculator=dict(type="BboxOverlaps2D_rotated_v1"))
    SAMPLER = dict(num=512, pos_fraction=0.25, add_gt_as_proposals=True)

    def __init__(self, num_classes: int, in_channels: int,
                 fc_out_channels: int = 1024, assigner: Optional[dict] = None,
                 sampler: Optional[dict] = None):
        super().__init__()
        self.num_classes = num_classes
        self.assigner = MaxIoUAssigner(**(assigner or self.ASSIGNER))
        self.sampler = RandomSampler(**(sampler or self.SAMPLER))
        self.coder = OrientedDeltaXYWHTCoder(
            target_stds=(0.1, 0.1, 0.2, 0.2, 0.1))
        self.extractor = OrientedSingleRoIExtractor(extend_factor=(1.4, 1.2))
        p = self.extractor.output_size
        cin = in_channels * p * p
        for i in range(self.NUM_SHARED_FCS):
            self.add_module(f"shared_fc{i}", nn.Linear(cin, fc_out_channels))
            cin = fc_out_channels
        self.fc_cls = nn.Linear(cin, num_classes + 1)
        self.fc_reg = nn.Linear(cin, self.REG_DIM)

    def forward_rois(self, feats, rois):
        """rois [R, 6] -> (cls_score [R, C+1], bbox_pred [R, 5]), f32.
        The FC input is the pooled [R, P, P, C] flattened in (P, P, C)
        order, as in the JAX head."""
        x = self.extractor(feats, rois)
        x = x.reshape(x.shape[0], -1)
        for i in range(self.NUM_SHARED_FCS):
            x = F.relu(linear(getattr(self, f"shared_fc{i}"), x))
        return linear(self.fc_cls, x).float(), linear(self.fc_reg, x).float()

    @torch.no_grad()
    def sample_rois(self, proposals, prop_valid, gt_obb, gt_mask,
                    gt_labels0, generator):
        """Assign and sample ``sampler.num`` roi slots per image.

        proposals [B, P, 5] and gt_obb [B, G, 5] in the OBB convention
        (angle already flipped), prop_valid [B, P], gt_mask [B, G],
        gt_labels0 [B, G] 0-based. The ground truths join the candidates
        (``add_gt_as_proposals``). Returns dict: rois [B, S, 5], labels
        [B, S] (background = num_classes), label_weights [B, S],
        bbox_targets and bbox_weights [B, S, 5]."""
        if self.sampler.add_gt_as_proposals:
            cand = torch.cat([proposals, gt_obb], 1)
            cand_valid = torch.cat([prop_valid, gt_mask], 1)
        else:
            cand, cand_valid = proposals, prop_valid
        assigned, _ = self.assigner.assign(cand, gt_obb, gt_mask,
                                           anchor_mask=cand_valid)
        pos, neg = self.sampler.sample(assigned, generator)
        # fixed slots: positives, then negatives, then the rest, each in
        # index order (the JAX f32 priority with its 1e-9 index
        # tiebreak, and the top-k that sends ties to the lower index)
        idx = torch.arange(cand.shape[1], device=cand.device)
        priority = pos.float() * 2.0 + neg.float() - idx * 1e-9
        _, sel = top_k(priority, self.sampler.num)
        sel_pos = torch.gather(pos, 1, sel)
        sel_neg = torch.gather(neg, 1, sel)
        rois = torch.gather(cand, 1, sel[..., None].expand(-1, -1, 5))
        matched = (torch.gather(assigned, 1, sel) - 1).clamp(
            0, gt_obb.shape[1] - 1)
        matched_gts = torch.gather(gt_obb, 1,
                                   matched[..., None].expand(-1, -1, 5))
        targets = self.coder.encode(rois, matched_gts)
        labels = torch.where(sel_pos, torch.gather(gt_labels0, 1, matched),
                             self.num_classes)
        return dict(
            rois=rois, labels=labels,
            label_weights=torch.where(sel_pos, 1.0, sel_neg.float()),
            bbox_targets=torch.where(sel_pos[..., None], targets, 0.0),
            bbox_weights=sel_pos[..., None].float().expand_as(targets))

    def loss(self, feats, proposals, prop_valid, targets, generator):
        """Training losses from the RPN's (detached) proposals
        [B, P, 5] / valid [B, P]; targets: "rboxes" [B, G, 5] (data
        convention), "labels" [B, G] (1-based), "gt_mask" [B, G]. CE
        averages over the slots with a positive weight, SmoothL1 (beta
        1) over all B * S slots, as the reference."""
        rboxes = targets["rboxes"].float()
        gt_obb = torch.cat([rboxes[..., :4], -rboxes[..., 4:]], dim=-1)
        gt_labels0 = (targets["labels"].long() - 1).clamp(min=0)
        sampled = self.sample_rois(proposals, prop_valid, gt_obb,
                                   targets["gt_mask"], gt_labels0, generator)
        b, s = sampled["labels"].shape
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=proposals.device).repeat_interleave(s)
        rois = torch.cat([batch_idx[:, None],
                          sampled["rois"].reshape(b * s, 5)], 1)
        cls_score, bbox_pred = self.forward_rois(feats, rois)
        label_weights = sampled["label_weights"].reshape(-1)
        loss_cls = softmax_cross_entropy(
            cls_score, sampled["labels"].reshape(-1), label_weights,
            avg_factor=(label_weights > 0).sum())
        loss_bbox = smooth_l1_loss(
            bbox_pred, sampled["bbox_targets"].reshape(-1, self.REG_DIM),
            sampled["bbox_weights"].reshape(-1, self.REG_DIM), beta=1.0,
            avg_factor=float(b * s))
        return dict(loss_cls=loss_cls, orcnn_bbox_loss=loss_bbox)

    def predict(self, feats, proposals, prop_valid, scale_factor):
        """Returns dict: polys [B, P, 8], scores [B, P, C] (softmax,
        background dropped), valid [B, P]."""
        b, p, _ = proposals.shape
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=proposals.device).repeat_interleave(p)
        rois = torch.cat([batch_idx[:, None], proposals.reshape(b * p, 5)], 1)
        cls_score, bbox_pred = self.forward_rois(feats, rois)
        scores = torch.softmax(cls_score, dim=-1)[:, :-1]
        obbs = self.coder.decode(rois[:, 1:], bbox_pred)
        # rescale to original image coordinates
        sf = scale_factor.float().repeat_interleave(p)[:, None]
        obbs = torch.cat([obbs[:, :4] / torch.clamp(sf, min=1e-6),
                          obbs[:, 4:]], 1)
        return dict(polys=B.obb2poly(obbs).reshape(b, p, 8),
                    scores=scores.reshape(b, p, self.num_classes),
                    valid=prop_valid)
