"""Gliding Vertex second stage (counterpart of
``rs_detection_tpu/models/roi_heads/gliding_head.py``).

Horizontal RoIAlign of the hbb proposals (``SingleRoIExtractor``, plain
PyTorch on every device, as the JAX extractor reaches no Pallas kernel),
``num_shared_fcs`` ReLU FCs, then four outputs: softmax cls (C + 1), an
hbb delta (4, ``GVDeltaXYWHBBoxCoder``), the sigmoid glide of each side's
vertex (4, ``GVFixCoder``) and the sigmoid ratio of the quad's area to
its hbb's (1, ``GVRatioCoder``). A detection is the decoded hbb with its
vertices glided, or the hbb itself where the ratio exceeds
``ratio_thr``. Training samples ``sampler.num`` slots an image through
``rbbox_head.sample_slots``, the cascade's sampler, and trains CE and
three smooth L1 losses at beta 1 and weight 1: the JAX head declares no
loss fields, so the config's ``bbox_loss`` / ``fix_loss`` /
``ratio_loss`` sections are dropped (ROADMAP.md, Queue 3)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...utils.registry import HEADS
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import GVDeltaXYWHBBoxCoder, GVFixCoder, GVRatioCoder
from ..boxes.sampler import RandomSampler
from ..losses.common import smooth_l1_loss, softmax_cross_entropy
from ..roi_extractors.oriented_single_level import SingleRoIExtractor
from ..utils.modules import linear
from .oriented_rpn_head import _take
from .rbbox_head import sample_slots


def _section(cfg, default, drop=()):
    return {k: v for k, v in dict(cfg or default).items()
            if k not in ("type",) + tuple(drop)}


@HEADS.register_module()
class GlidingHead(nn.Module):
    """The JAX head's arguments with its defaults; ``assigner``,
    ``sampler``, ``bbox_coder`` and ``bbox_roi_extractor`` are config
    sections (their ``type`` dropped; the assigner's IoU calculator,
    ignore threshold and fill value dropped too, as in JAX: hbb IoU).
    ``score_thresh`` is recorded and not used, as in JAX. Layer names
    are the flax ones: ``shared_fc{i}``, ``fc_cls``, ``fc_reg``,
    ``fc_fix``, ``fc_ratio``."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 fc_out_channels: int = 1024, num_shared_fcs: int = 2,
                 score_thresh: float = 0.05, ratio_thr: float = 0.8,
                 pos_weight: float = -1.0, assigner=None, sampler=None,
                 bbox_coder=None, bbox_roi_extractor=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_shared_fcs = num_shared_fcs
        self.score_thresh = score_thresh
        self.ratio_thr = ratio_thr
        self.pos_weight = pos_weight
        self.assigner = MaxIoUAssigner(**_section(
            assigner, dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                           match_low_quality=False),
            ("assigned_labels_filled", "iou_calculator", "ignore_iof_thr")))
        self.sampler = RandomSampler(**_section(
            sampler, dict(num=512, pos_fraction=0.25,
                          add_gt_as_proposals=True)))
        self.coder = GVDeltaXYWHBBoxCoder(**_section(
            bbox_coder, dict(target_means=(0.0,) * 4,
                             target_stds=(0.1, 0.1, 0.2, 0.2))))
        self.fix_coder = GVFixCoder()
        self.ratio_coder = GVRatioCoder()
        ex = _section(bbox_roi_extractor,
                      dict(roi_layer=dict(output_size=7, sampling_ratio=2),
                           out_channels=256, featmap_strides=[4, 8, 16, 32]),
                      ("extend_factor",))
        if "roi_layer" in ex:
            ex["roi_layer"] = _section(ex["roi_layer"], {})
        self.extractor = SingleRoIExtractor(**ex)
        p = self.extractor.output_size
        width = in_channels * p * p
        for i in range(num_shared_fcs):
            self.add_module(f"shared_fc{i}", nn.Linear(
                width if i == 0 else fc_out_channels, fc_out_channels))
        fc = fc_out_channels if num_shared_fcs else width
        self.fc_cls = nn.Linear(fc, num_classes + 1)
        self.fc_reg = nn.Linear(fc, 4)
        self.fc_fix = nn.Linear(fc, 4)
        self.fc_ratio = nn.Linear(fc, 1)

    def init_weights(self, g: torch.Generator) -> None:
        """The JAX head's initializers for the glide and ratio FCs,
        N(0, 0.001) with zero biases (the shared, cls and reg FCs take
        the generic ones of ``flagship.init_weights``)."""
        with torch.no_grad():
            for m in (self.fc_fix, self.fc_ratio):
                m.weight.normal_(0.0, 0.001, generator=g)
                nn.init.zeros_(m.bias)

    def forward_rois(self, feats, rois):
        """rois [R, 5] (b, x1, y1, x2, y2) -> f32 (cls [R, C + 1], hbb
        deltas [R, 4], glides [R, 4], ratios [R, 1])."""
        x = self.extractor(feats, rois)
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_shared_fcs):
            x = F.relu(linear(getattr(self, f"shared_fc{i}"), x))
        return (linear(self.fc_cls, x).float(), linear(self.fc_reg, x).float(),
                torch.sigmoid(linear(self.fc_fix, x).float()),
                torch.sigmoid(linear(self.fc_ratio, x).float()))

    def loss(self, feats, proposals, prop_valid, targets, generator):
        """Training losses from the RPN's (detached) hbb proposals
        [B, P, 4] / valid [B, P]; targets "hboxes" [B, G, 4], "polys"
        [B, G, 8], "labels" [B, G] (1-based), "gt_mask" [B, G]."""
        gt_hbb = targets["hboxes"].float()
        gt_poly = targets["polys"].float()
        gt_mask = targets["gt_mask"].bool()
        gt_labels0 = (targets["labels"].long() - 1).clamp(min=0)
        b = proposals.shape[0]
        s = self.sampler.num
        if self.sampler.add_gt_as_proposals:
            cand = torch.cat([proposals.float(), gt_hbb], 1)
            cand_valid = torch.cat([prop_valid, gt_mask], 1)
        else:
            cand, cand_valid = proposals.float(), prop_valid
        sel, pos, neg, matched = sample_slots(
            cand, cand_valid, gt_hbb, gt_mask, generator, self.assigner,
            self.sampler)
        rois = _take(cand, sel)
        poly_m = _take(gt_poly, matched)
        p3 = pos[..., None]
        bbox_t = torch.where(p3, self.coder.encode(
            rois, _take(gt_hbb, matched)), 0.0)
        fix_t = torch.where(p3, self.fix_coder.encode(poly_m), 0.0)
        ratio_t = torch.where(p3, self.ratio_coder.encode(poly_m), 0.0)
        labels = torch.where(pos, torch.gather(gt_labels0, 1, matched),
                             self.num_classes).reshape(-1)
        pw = 1.0 if self.pos_weight <= 0 else self.pos_weight
        lw = torch.where(pos, pw, neg.float()).reshape(-1)
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=rois.device).repeat_interleave(s)
        cls, reg, fix, ratio = self.forward_rois(
            feats, torch.cat([batch_idx[:, None], rois.reshape(b * s, 4)], 1))
        posf = pos.reshape(-1, 1).float()
        n = float(b * s)
        return dict(
            gliding_cls_loss=softmax_cross_entropy(
                cls, labels, lw, avg_factor=(lw > 0).sum()),
            gliding_bbox_loss=smooth_l1_loss(
                reg, bbox_t.reshape(-1, 4), posf, avg_factor=n),
            gliding_fix_loss=smooth_l1_loss(
                fix, fix_t.reshape(-1, 4), posf, avg_factor=n),
            gliding_ratio_loss=smooth_l1_loss(
                ratio, ratio_t.reshape(-1, 1), posf, avg_factor=n))

    def predict(self, feats, proposals, prop_valid, scale_factor):
        """hbb proposals [B, P, 4] -> dict: polys [B, P, 8], scores
        [B, P, C] (softmax, background dropped), valid [B, P]. Boxes are
        divided by ``scale_factor`` [B]."""
        b, p, _ = proposals.shape
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=proposals.device).repeat_interleave(p)
        rois = torch.cat([batch_idx[:, None],
                          proposals.reshape(b * p, 4).float()], 1)
        cls, reg, fix, ratio = self.forward_rois(feats, rois)
        scores = torch.softmax(cls, dim=-1)[:, :-1]
        hbb = B.delta2bbox(rois[:, 1:], reg, self.coder.means,
                           self.coder.stds)
        polys = torch.where(ratio > self.ratio_thr, B.hbb2poly(hbb),
                            self.fix_coder.decode(hbb, fix))
        sf = scale_factor.float().repeat_interleave(p)[:, None]
        polys = polys / sf.clamp(min=1e-6)
        return dict(polys=polys.reshape(b, p, 8),
                    scores=scores.reshape(b, p, self.num_classes),
                    valid=prop_valid)
