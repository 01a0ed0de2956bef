"""Rotated NMS with fixed-size outputs (counterpart of
``rs_detection_tpu/ops/nms_rotated.py``): ``nms_rotated_mask`` (class
aware when given labels), the eager ``nms_rotated`` / ``ml_nms_rotated``,
``multiclass_nms_rotated_jit`` (the name kept: a static candidate cap
and fixed-size dets, labels and valid, as the detection heads call it)
and its eager wrapper ``multiclass_nms_rotated``. Plain PyTorch on the
exact rotated IoU (``ops/rotated_iou.py``) and the Jacobi greedy
suppression of ``ops/nms.py``; every sort and top-k is stable (ties to
the lower index, as ``jnp.argsort`` and ``jax.lax.top_k``), so the card
and the CPU order ties alike."""

from __future__ import annotations

import torch

from .nms import greedy_suppress_mask, top_k
from .rotated_iou import box_iou_rotated


def nms_rotated_mask(dets, scores, iou_threshold, valid=None, labels=None):
    """Keep mask, in input order, of greedy rotated NMS: dets [N, 5+],
    scores [N], valid [N] bool (None: all), labels [N] (given: a box
    suppresses only boxes of its own label)."""
    n = dets.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dets.device)
    s = torch.where(valid, scores, -torch.inf)
    order = torch.sort(s, descending=True, stable=True).indices
    b = dets[order, :5]
    iou = box_iou_rotated(b, b)
    if labels is not None:
        lab = labels[order]
        iou = torch.where(lab[:, None] == lab[None, :], iou, 0.0)
    keep_sorted = greedy_suppress_mask(iou > iou_threshold, valid[order])
    return torch.zeros_like(valid).scatter(0, order, keep_sorted)


def _kept_by_score(keep, scores):
    idx = keep.nonzero().squeeze(1)
    return idx[torch.sort(scores[idx], descending=True, stable=True).indices]


def nms_rotated(dets, scores, iou_threshold):
    """Kept indices, by descending score (reference ``:527``)."""
    if dets.shape[0] == 0:
        return torch.zeros(0, dtype=torch.long, device=dets.device)
    return _kept_by_score(nms_rotated_mask(dets, scores, iou_threshold),
                          scores)


def ml_nms_rotated(dets, scores, labels, iou_threshold):
    """The class-aware form of ``nms_rotated`` (reference ``:515``)."""
    if dets.shape[0] == 0:
        return torch.zeros(0, dtype=torch.long, device=dets.device)
    return _kept_by_score(nms_rotated_mask(dets, scores, iou_threshold,
                                           labels=labels), scores)


def multiclass_nms_rotated_jit(multi_bboxes, multi_scores, score_thr,
                               iou_thr, pre_nms: int = 2000,
                               max_num: int = 2000, score_factors=None):
    """Multiclass rotated NMS with a fixed output size.

    multi_bboxes [N, 5] (shared) or [N, (C+1)*5] (per class, the
    background's first); multi_scores [N, C+1], the background in column
    0. The ``pre_nms`` best (box, class) scores above ``score_thr`` enter
    a class-aware NMS at ``iou_thr``. Returns dets [max_num, 6] (obb and
    score), labels [max_num] (0-based, -1 for padding) and valid
    [max_num] bool, by descending score."""
    n = multi_scores.shape[0]
    num_classes = multi_scores.shape[1] - 1
    scores = multi_scores[:, 1:]
    if score_factors is not None:
        scores = scores * score_factors[:, None]
    if multi_bboxes.shape[1] > 5:
        bboxes = multi_bboxes.reshape(n, -1, 5)[:, 1:]
    else:
        bboxes = multi_bboxes[:, None, :].expand(n, num_classes, 5)
    flat_scores = scores.reshape(-1)
    flat_boxes = bboxes.reshape(-1, 5)
    flat_labels = torch.arange(num_classes,
                               device=scores.device).repeat(n)
    k = min(pre_nms, flat_scores.shape[0])
    top_scores, top_idx = top_k(
        torch.where(flat_scores > score_thr, flat_scores, -torch.inf), k)
    cand_boxes = flat_boxes[top_idx]
    cand_labels = flat_labels[top_idx]
    keep = nms_rotated_mask(cand_boxes, top_scores, iou_thr,
                            valid=top_scores > score_thr, labels=cand_labels)
    out_scores, sel = top_k(torch.where(keep, top_scores, -torch.inf),
                            min(max_num, k))
    out_valid = torch.isfinite(out_scores)
    out_labels = torch.where(out_valid, cand_labels[sel], -1)
    dets = torch.cat([cand_boxes[sel],
                      torch.where(out_valid, out_scores, 0.0)[:, None]], 1)
    if max_num > k:
        pad = max_num - k
        dets = torch.cat([dets, dets.new_zeros(pad, 6)])
        out_labels = torch.cat([out_labels, out_labels.new_full((pad,), -1)])
        out_valid = torch.cat([out_valid, out_valid.new_zeros(pad)])
    return dets, out_labels, out_valid


def multiclass_nms_rotated(multi_bboxes, multi_scores, score_thr, nms_cfg,
                           max_num=-1, score_factors=None):
    """The reference's signature (``:540-596``): (dets [k, 6], labels
    [k]) of the kept boxes, sized by what is kept; at most ``max_num``
    (2000 when not positive)."""
    iou_thr = dict(nms_cfg).get("iou_thr", 0.1)
    n = multi_scores.shape[0]
    if n == 0:
        return (multi_scores.new_zeros(0, 6),
                torch.zeros(0, dtype=torch.long, device=multi_scores.device))
    dets, labels, valid = multiclass_nms_rotated_jit(
        multi_bboxes, multi_scores, float(score_thr), float(iou_thr),
        pre_nms=min(2000, n * (multi_scores.shape[1] - 1)),
        max_num=max_num if max_num > 0 else 2000,
        score_factors=score_factors)
    return dets[valid], labels[valid]
