"""RoI-Transformer cascade head (counterpart of
``rs_detection_tpu/models/roi_heads/rbbox_head.py``).

Stage 1 (``SharedFCBBoxHeadRbbox``): horizontal RoIAlign of the hbb
proposals, 2 FCs, softmax cls and a class-agnostic 5-dim delta of a
*rotated* box against the proposal turned into an obb (``hbb2obb``).
Stage 2 (``BBoxHeadRbbox``): rotated RoIAlign (K1, backward K3, on CUDA
tensors) of the stage-1 boxes, 2 FCs, softmax cls and a refinement
delta. ``num_stages=1`` is FasterRCNN-OBB: stage 1 alone.

Sampling gives every image ``sampler_num`` fixed slots, positives first
(the JAX priority ``2 pos + neg - i 1e-9``, whose index term is lost next
to 2.0 in f32, so ties decide: the stable ``ops.nms.top_k`` sends them to
the lower index, as ``jax.lax.top_k``). The ground truths are in the
data's angle convention, as the JAX head takes them (no sign flip, unlike
``OrientedHead``), and detections leave as JDet-convention polygons."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import top_k
from ...utils.registry import HEADS
from ..boxes.assigner import MaxIoUAssigner
from ..boxes.coder import DeltaXYWHABBoxCoder
from ..boxes.sampler import RandomSampler
from ..losses.common import smooth_l1_loss, softmax_cross_entropy
from ..losses.poly_iou_loss import kfiou_loss
from ..networks.compat import config_fields
from ..roi_extractors.oriented_single_level import (
    OrientedSingleRoIExtractor, SingleRoIExtractor)
from ..utils.modules import linear
from .oriented_rpn_head import _take

ROI_LAYER = dict(output_size=7, sampling_ratio=2)


@torch.no_grad()
def sample_slots(cand, cand_valid, gts, gt_mask, generator, assigner,
                 sampler):
    """``sampler.num`` fixed slots of the candidates [B, N, D] against
    the ground truths gts [B, G, D'], positives first: (sel [B, S], pos,
    neg [B, S], matched ground-truth index [B, S]). The second stage of
    every two-stage head with a ``RandomSampler`` samples through it."""
    assigned, _ = assigner.assign(cand, gts, gt_mask, anchor_mask=cand_valid)
    pos, neg = sampler.sample(assigned, generator)
    idx = torch.arange(cand.shape[1], device=cand.device)
    priority = pos.float() * 2.0 + neg.float() - idx * 1e-9
    _, sel = top_k(priority, sampler.num)
    matched = (torch.gather(assigned, 1, sel) - 1).clamp(0, gts.shape[1] - 1)
    return (sel, torch.gather(pos, 1, sel), torch.gather(neg, 1, sel),
            matched)


class FCHead(nn.Module):
    """The shared 2-FC trunk (1024 wide, ReLU) and the cls / reg linears
    of one stage; the flax names ``fc0``, ``fc1``, ``fc_cls``,
    ``fc_reg``. The input is the pooled [R, P, P, C] flattened in (P, P,
    C) order."""

    def __init__(self, in_features: int, num_classes: int, reg_dim: int,
                 fc_out: int = 1024):
        super().__init__()
        self.fc0 = nn.Linear(in_features, fc_out)
        self.fc1 = nn.Linear(fc_out, fc_out)
        self.fc_cls = nn.Linear(fc_out, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out, reg_dim)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = F.relu(linear(self.fc0, x))
        x = F.relu(linear(self.fc1, x))
        return linear(self.fc_cls, x).float(), linear(self.fc_reg, x).float()


@HEADS.register_module()
class RoITransformerHead(nn.Module):
    """Both cascade stages, the JAX head's arguments with its defaults
    (``reg_loss`` "smooth_l1" or "kfiou" for stage 2; ``score_thresh`` is
    recorded and not used, as in JAX)."""

    def __init__(self, num_classes: int = 15, in_channels: int = 256,
                 featmap_strides=(4, 8, 16, 32),
                 stage1_stds=(0.1, 0.1, 0.2, 0.2, 0.1),
                 stage2_stds=(0.05, 0.05, 0.1, 0.1, 0.05),
                 score_thresh: float = 0.05, sampler_num: int = 512,
                 pos_fraction: float = 0.25, reg_loss: str = "smooth_l1",
                 num_stages: int = 2):
        super().__init__()
        if reg_loss not in ("smooth_l1", "kfiou"):
            raise ValueError(f"RoITransformerHead: reg_loss {reg_loss!r}")
        if num_stages not in (1, 2):
            raise ValueError(f"RoITransformerHead: num_stages {num_stages}")
        self.num_classes = num_classes
        self.score_thresh = score_thresh
        self.reg_loss = reg_loss
        self.num_stages = num_stages
        strides = list(featmap_strides)
        self.h_extractor = SingleRoIExtractor(
            roi_layer=ROI_LAYER, out_channels=in_channels,
            featmap_strides=strides)
        self.r_extractor = OrientedSingleRoIExtractor(
            roi_layer=ROI_LAYER, out_channels=in_channels,
            featmap_strides=strides) if num_stages == 2 else None
        self.coder1 = DeltaXYWHABBoxCoder(target_stds=tuple(stage1_stds))
        self.coder2 = DeltaXYWHABBoxCoder(target_stds=tuple(stage2_stds))
        thr = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                   match_low_quality=False)
        self.assigner_h = MaxIoUAssigner(**thr)
        self.assigner_r = MaxIoUAssigner(
            **thr, iou_calculator=dict(type="BboxOverlaps2D_rotated"))
        self.sampler = RandomSampler(num=sampler_num,
                                     pos_fraction=pos_fraction,
                                     add_gt_as_proposals=True)
        p = ROI_LAYER["output_size"]
        self.stage1 = FCHead(in_channels * p * p, num_classes, 5)
        self.stage2 = FCHead(in_channels * p * p, num_classes, 5) \
            if num_stages == 2 else None

    def _cls_loss(self, cls, labels, pos, neg):
        lw = (pos | neg).reshape(-1).float()
        return softmax_cross_entropy(cls, labels.reshape(-1), lw,
                                     avg_factor=(lw > 0).sum())

    def loss(self, feats, proposals, prop_valid, targets, generator):
        """Training losses from the RPN's (detached) hbb proposals
        [B, P, 4] / valid [B, P]; targets "rboxes" [B, G, 5], "hboxes"
        [B, G, 4], "labels" [B, G] (1-based), "gt_mask" [B, G]. Stage 2
        samples the boxes stage 1 decodes from its detached regression."""
        gt_rbox = targets["rboxes"].float()
        gt_hbb = targets["hboxes"].float()
        gt_mask = targets["gt_mask"]
        gt_labels0 = (targets["labels"].long() - 1).clamp(min=0)
        b = proposals.shape[0]
        s = self.sampler.num
        dev = proposals.device
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=dev).repeat_interleave(s)[:, None]

        # stage 1: hbb rois -> rbox deltas
        cand = torch.cat([proposals.float(), gt_hbb], 1)
        sel, pos1, neg1, matched = sample_slots(
            cand, torch.cat([prop_valid, gt_mask], 1), gt_hbb, gt_mask,
            generator, self.assigner_h, self.sampler)
        rois_h = _take(cand, sel)
        rrois = B.hbb2obb(rois_h)
        t1 = self.coder1.encode(rrois, _take(gt_rbox, matched))
        labels1 = torch.where(pos1, torch.gather(gt_labels0, 1, matched),
                              self.num_classes)
        cls1, reg1 = self.stage1(self.h_extractor(
            feats, torch.cat([batch_idx, rois_h.reshape(b * s, 4)], 1)))
        pos1f = pos1.reshape(-1, 1).float()
        losses = dict(
            rbbox_cls_loss_1=self._cls_loss(cls1, labels1, pos1, neg1),
            rbbox_reg_loss_1=smooth_l1_loss(
                reg1, torch.where(pos1[..., None], t1, 0.0).reshape(-1, 5),
                pos1f, avg_factor=float(b * s)))
        if self.num_stages == 1:
            return losses

        # stage 2: decoded rboxes -> refinement
        rboxes1 = self.coder1.decode(rrois.reshape(b * s, 5),
                                     reg1.detach()).reshape(b, s, 5)
        cand = torch.cat([rboxes1, gt_rbox], 1)
        valid = torch.ones(b, s, dtype=torch.bool, device=dev)
        sel, pos2, neg2, matched = sample_slots(
            cand, torch.cat([valid, gt_mask], 1), gt_rbox, gt_mask,
            generator, self.assigner_r, self.sampler)
        rois_r = _take(cand, sel)
        matched_gt = _take(gt_rbox, matched)
        t2 = torch.where(pos2[..., None], self.coder2.encode(
            rois_r, matched_gt), 0.0).reshape(-1, 5)
        labels2 = torch.where(pos2, torch.gather(gt_labels0, 1, matched),
                              self.num_classes)
        cls2, reg2 = self.stage2(self.r_extractor(
            feats, torch.cat([batch_idx, rois_r.reshape(b * s, 5)], 1)))
        losses["rbbox_cls_loss_2"] = self._cls_loss(cls2, labels2, pos2,
                                                    neg2)
        p2 = pos2.reshape(-1, 1)
        if self.reg_loss == "kfiou":
            # negatives get unit dummy boxes: their weight is 0, but a
            # degenerate (w = h = 0) box makes the Gaussian singular and
            # the loss NaN, and NaN x 0 is NaN; mask the inputs
            dummy = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0], device=dev)
            rois_flat = torch.where(p2, rois_r.reshape(-1, 5), dummy)
            pred_dec = self.coder2.decode(rois_flat,
                                          torch.where(p2, reg2, 0.0))
            tgt_dec = torch.where(p2, matched_gt.reshape(-1, 5), dummy)
            losses["rbbox_reg_loss_2"] = kfiou_loss(
                reg2, t2, pred_decode=pred_dec, targets_decode=tgt_dec,
                weight=p2[:, 0].float(), avg_factor=p2.sum())
        else:
            losses["rbbox_reg_loss_2"] = smooth_l1_loss(
                reg2, t2, p2.float(), avg_factor=float(b * s))
        return losses

    def predict(self, feats, proposals, prop_valid, scale_factor):
        """hbb proposals [B, P, 4] -> dict: polys [B, P, 8] (JDet
        convention), scores [B, P, C] (softmax, background dropped),
        valid [B, P]. Boxes are divided by ``scale_factor`` [B]."""
        b, p, _ = proposals.shape
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=proposals.device).repeat_interleave(p)
        rois_h = torch.cat([batch_idx[:, None],
                            proposals.reshape(b * p, 4).float()], 1)
        cls, reg1 = self.stage1(self.h_extractor(feats, rois_h))
        obbs = self.coder1.decode(B.hbb2obb(rois_h[:, 1:]), reg1)
        if self.num_stages == 2:
            cls, reg2 = self.stage2(self.r_extractor(
                feats, torch.cat([batch_idx[:, None], obbs], 1)))
            obbs = self.coder2.decode(obbs, reg2)
        scores = torch.softmax(cls, dim=-1)[:, :-1]
        sf = scale_factor.float().repeat_interleave(p)[:, None]
        obbs = torch.cat([obbs[:, :4] / torch.clamp(sf, min=1e-6),
                          obbs[:, 4:]], 1)
        return dict(polys=B.rotated_box_to_poly(obbs).reshape(b, p, 8),
                    scores=scores.reshape(b, p, self.num_classes),
                    valid=prop_valid)


# the reference head names (convfc_rbbox_head.py)
HEADS.register_module(name="SharedFCBBoxHeadRbbox", module=RoITransformerHead)
HEADS.register_module(name="BBoxHeadRbbox", module=RoITransformerHead)
HEADS.register_module(name="ConvFCBBoxHeadRbbox", module=RoITransformerHead)
# the classic Faster R-CNN box head's legacy name (rpn_head.py:189-200)
HEADS.register_module(name="FasterrcnnHead", module=RoITransformerHead)


@HEADS.register_module(name="KFIoUSharedFCBBoxHeadRbbox")
def kfiou_shared_fc_head(**kw):
    """The shared-FC rbbox head with the KFIoU stage-2 loss; keys the
    head does not take are dropped, as the JAX factory drops them."""
    kw.setdefault("reg_loss", "kfiou")
    fields = set(config_fields(RoITransformerHead))
    return RoITransformerHead(**{k: v for k, v in kw.items() if k in fields})
