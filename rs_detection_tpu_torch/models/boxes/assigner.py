"""Max-IoU assignment (counterpart of
``rs_detection_tpu/models/boxes/assigner.py``), batched over leading
image axes.

Ground truths come padded to a fixed count with a validity mask; a padded
column, and every column of an anchor excluded by ``anchor_mask``, is
set to IoU -1 so it can never win. The result is dense per anchor:
-1 = ignore, 0 = negative, k > 0 = matched to ground truth k - 1.
"""

from __future__ import annotations

import torch

from ...ops.nms import bbox_overlaps_hbb
from ...ops.rotated_iou import box_iou_rotated
from ...utils.registry import BOXES


def assign_wrt_overlaps(overlaps, gt_mask, pos_iou_thr: float, neg_iou_thr,
                        min_pos_iou: float = 0.0,
                        match_low_quality: bool = True,
                        gt_max_assign_all: bool = True, anchor_mask=None):
    """Assign anchors from an IoU matrix.

    overlaps [..., A, G]; gt_mask [..., G] bool; anchor_mask [..., A]
    bool or None; ``neg_iou_thr`` a float or a (lo, hi) pair. Returns
    (assigned [..., A] int64 in the -1 / 0 / k+1 encoding, max IoU
    [..., A]). Ties go to the lower ground-truth index (``argmax``, as
    ``jnp.argmax``); in a low-quality rescue the later ground truth wins,
    as the reference's per-gt overwrite loop."""
    masked = torch.where(gt_mask[..., None, :], overlaps, -1.0)
    if anchor_mask is not None:
        # an excluded anchor (outside the border) becomes neither a
        # negative nor a rescue match: the reference removes it
        masked = torch.where(anchor_mask[..., :, None], masked, -1.0)
    max_overlaps = masked.amax(dim=-1)
    argmax = masked.argmax(dim=-1)
    assigned = torch.full_like(argmax, -1)
    if isinstance(neg_iou_thr, (tuple, list)):
        lo, hi = neg_iou_thr
        neg = (max_overlaps >= lo) & (max_overlaps < hi)
    else:
        neg = (max_overlaps >= 0) & (max_overlaps < neg_iou_thr)
    assigned = torch.where(neg, 0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax + 1, assigned)
    if match_low_quality:
        gt_max = masked.amax(dim=-2, keepdim=True)                # [..., 1, G]
        is_best = ((masked == gt_max) & gt_mask[..., None, :]
                   & (gt_max >= min_pos_iou) & (gt_max > 0))
        if not gt_max_assign_all:
            first = masked.argmax(dim=-2, keepdim=True)
            is_best = is_best & torch.zeros_like(is_best).scatter(-2, first,
                                                                  True)
        g = masked.shape[-1]
        gt_ids = torch.arange(1, g + 1, device=masked.device)
        last = torch.where(is_best, gt_ids, -1).amax(dim=-1)
        assigned = torch.where(is_best.any(dim=-1), last, assigned)
    return assigned, max_overlaps


@BOXES.register_module()
class MaxIoUAssigner:
    """Assigner built from a config dict (reference ``assigner.py``):
    hbb IoU, or rotated IoU when ``iou_calculator`` names a rotated one.
    ``ignore_iof_thr`` (ignore regions) is not ported: no config of the
    port sets it."""

    def __init__(self, pos_iou_thr, neg_iou_thr, min_pos_iou=0.0,
                 gt_max_assign_all=True, ignore_iof_thr=-1,
                 match_low_quality=True, iou_calculator=None, **_):
        if ignore_iof_thr > 0:
            raise NotImplementedError("MaxIoUAssigner: ignore regions "
                                      "(ignore_iof_thr > 0) are not ported")
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = (tuple(neg_iou_thr)
                            if isinstance(neg_iou_thr, (list, tuple))
                            else neg_iou_thr)
        self.min_pos_iou = min_pos_iou
        self.gt_max_assign_all = gt_max_assign_all
        self.match_low_quality = match_low_quality
        kind = (iou_calculator or {}).get("type", "")
        self.rotated = "rotated" in kind.lower()

    def overlaps(self, bboxes, gt_bboxes):
        if self.rotated:
            return box_iou_rotated(bboxes[..., :5], gt_bboxes[..., :5])
        return bbox_overlaps_hbb(bboxes[..., :4], gt_bboxes[..., :4])

    @torch.no_grad()
    def assign(self, bboxes, gt_bboxes, gt_mask, anchor_mask=None):
        """bboxes [..., A, D] against gt_bboxes [..., G, D] -> (assigned
        [..., A], max IoU [..., A])."""
        return assign_wrt_overlaps(
            self.overlaps(bboxes, gt_bboxes), gt_mask, self.pos_iou_thr,
            self.neg_iou_thr, self.min_pos_iou, self.match_low_quality,
            self.gt_max_assign_all, anchor_mask=anchor_mask)


@BOXES.register_module()
class MaxIoUAssignerRbbox(MaxIoUAssigner):
    """Rotated IoU whatever ``iou_calculator`` says (the JAX class's
    ``iou_kind`` is "rotated" and only a rotated calculator sets it)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.rotated = True
