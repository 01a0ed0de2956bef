"""Horizontal-box IoU and NMS (counterpart of
``rs_detection_tpu/ops/nms.py``): the RPN's pieces, batched over a
leading image axis; ``nms_mask`` on tensors, and the host helpers
``nms`` and ``multiclass_nms`` that take numpy arrays, as the JAX ones
do. ``fast_top_k`` is not ported: it is the TPU's approximate top-k, and
``top_k`` here is exact."""

from __future__ import annotations

import numpy as np
import torch


def bbox_overlaps_hbb(boxes1, boxes2, mode: str = "iou", offset: float = 0.0):
    """Pairwise hbb IoU: [..., N, 4] x [..., M, 4] -> [..., N, M]
    (``mode="iof"``: intersection over the area of ``boxes1``); 0 where
    the denominator is not positive. Per-coordinate [..., N, M] terms,
    no [..., N, M, 2] stack: the RPN calls it on 600k anchors."""
    ax1, ay1, ax2, ay2 = (t[..., :, None] for t in boxes1[..., :4].unbind(-1))
    bx1, by1, bx2, by2 = (t[..., None, :] for t in boxes2[..., :4].unbind(-1))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + offset).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + offset).clamp(min=0)
    inter = iw * ih
    area1 = (ax2 - ax1 + offset) * (ay2 - ay1 + offset)
    if mode == "iof":
        denom = area1
    else:
        denom = area1 + (bx2 - bx1 + offset) * (by2 - by1 + offset) - inter
    ok = denom > 0
    return torch.where(ok, inter / torch.where(ok, denom, 1.0), 0.0)


def overlap_gt_mask_hbb(boxes, thresh: float, offset: float = 0.0):
    """Pairwise ``iou > thresh`` of hbbs ``[..., N, 4]`` -> ``[..., N, N]``
    bool, division-free: ``inter * (1 + t) > t * (a1 + a2)``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    ix = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]) + offset)
    iy = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]) + offset)
    inter = torch.clamp(ix, min=0) * torch.clamp(iy, min=0)
    area = (x2 - x1 + offset) * (y2 - y1 + offset)
    return inter * (1.0 + thresh) > thresh * (area[..., :, None]
                                              + area[..., None, :])


def greedy_suppress_mask(over, order_valid):
    """Greedy NMS keep mask of score-sorted boxes from their pairwise
    overlap mask ``over [..., N, N]`` and validity ``[..., N]``.

    Jacobi fixpoint, as ``_greedy_suppress_mask`` in the JAX package:
    every sweep recomputes all keeps from the last ones, and after t
    sweeps every box whose suppression chain is at most t long is
    final, so the loop ends at the exact sequential-greedy result."""
    n = over.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=over.device).triu(1)
    m = over & upper & order_valid[..., :, None] & order_valid[..., None, :]
    keep = order_valid
    for _ in range(n):
        sup = (m & keep[..., :, None]).any(dim=-2)
        new = order_valid & ~sup
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def top_k(x, k: int):
    """Exact top-k along the last axis, ties to the lower index (the
    order ``jax.lax.top_k`` gives). The TPU path's ``fast_top_k`` is
    approximate above 16384 candidates; the port is exact everywhere."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_mask(boxes, scores, iou_threshold, valid=None):
    """Keep mask, in input order, of greedy hbb NMS over ``boxes`` [N, 4]
    and ``scores`` [N] on their device; ``valid`` [N] marks live entries
    (the others score -inf and are never kept). The boxes go in stable
    descending score order, as JAX's ``argsort(-s)``."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    s = torch.where(valid, scores, -torch.inf)
    order = torch.sort(-s, stable=True).indices
    b = boxes[order]
    keep_sorted = greedy_suppress_mask(bbox_overlaps_hbb(b, b)
                                       > iou_threshold, valid[order])
    return torch.zeros(n, dtype=torch.bool, device=boxes.device) \
        .index_put((order,), keep_sorted)


def nms(boxes, scores, iou_threshold):
    """Kept indices of hbb NMS (host numpy in and out, ``nms_mask`` on the
    CPU), by descending score in the JAX helper's numpy order."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.int64)
    keep = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                    iou_threshold).numpy()
    idx = np.nonzero(keep)[0]
    return idx[np.argsort(-scores[idx])]


def multiclass_nms(mlvl_bboxes, mlvl_scores, score_thr, nms_cfg, max_num=-1):
    """Per-class hbb NMS over numpy boxes [N, 4] and scores [N, C]:
    (dets [K, 5] with the score last, labels [K]) by descending score, at
    most ``max_num`` when positive; ``nms_cfg["iou_thr"]`` (0.5)."""
    num_classes = mlvl_scores.shape[1]
    out_boxes, out_labels = [], []
    iou_thr = nms_cfg.get("iou_thr", 0.5)
    for c in range(num_classes):
        mask = mlvl_scores[:, c] > score_thr
        if not mask.any():
            continue
        boxes_c = mlvl_bboxes[mask]
        scores_c = mlvl_scores[mask, c]
        keep = nms(boxes_c, scores_c, iou_thr)
        out_boxes.append(np.concatenate([boxes_c[keep], scores_c[keep, None]],
                                        1))
        out_labels.append(np.full((len(keep),), c, np.int64))
    if not out_boxes:
        return np.zeros((0, 5), np.float32), np.zeros((0,), np.int64)
    dets = np.concatenate(out_boxes, 0)
    labels = np.concatenate(out_labels, 0)
    order = np.argsort(-dets[:, 4])
    if max_num > 0:
        order = order[:max_num]
    return dets[order], labels[order]
