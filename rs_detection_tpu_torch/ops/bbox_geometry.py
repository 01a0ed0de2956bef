"""Generic box geometry on the host, numpy (counterpart of
``rs_detection_tpu/ops/bbox_geometry.py``): overlaps that dispatch on the
box type (an hbb fast path, the exact polygon intersection of
``ops/nms_poly.py:iou_poly_single`` otherwise), areas of hbbs, obbs and
polygons, and two greedy NMS variants. Devkit and offline helpers, as in
the JAX package; the on-device forms are ``ops/rotated_iou.py`` and
``ops/nms*.py``.
"""

from __future__ import annotations

import numpy as np

from .box_ops import get_bbox_type
from .nms_poly import iou_poly_single


def _to_np(x):
    return np.asarray(x, dtype=np.float32)


def _as_hbb(bboxes, btype):
    if btype == "hbb":
        return bboxes
    if btype == "obb":
        cx, cy, w, h, t = np.moveaxis(bboxes, -1, 0)
        dx = 0.5 * (np.abs(w * np.cos(t)) + np.abs(h * np.sin(t)))
        dy = 0.5 * (np.abs(w * np.sin(t)) + np.abs(h * np.cos(t)))
        return np.stack([cx - dx, cy - dy, cx + dx, cy + dy], -1)
    pts = bboxes.reshape(*bboxes.shape[:-1], 4, 2)
    return np.concatenate([pts.min(-2), pts.max(-2)], -1)


def _as_poly(bboxes, btype):
    if btype == "poly":
        return bboxes
    if btype == "hbb":
        x1, y1, x2, y2 = np.moveaxis(bboxes, -1, 0)
        return np.stack([x1, y1, x2, y1, x2, y2, x1, y2], -1)
    cx, cy, w, h, t = np.moveaxis(bboxes, -1, 0)
    c, s = np.cos(t), np.sin(t)
    dx, dy = 0.5 * w, 0.5 * h
    pts = []
    for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        pts += [cx + sx * dx * c - sy * dy * s,
                cy + sx * dx * s + sy * dy * c]
    return np.stack(pts, -1)


def bbox_overlaps(bboxes1, bboxes2, mode="iou", is_aligned=False,
                  eps=1e-6):
    """Generic [N, M] (or aligned [N, 1]) IoU/IoF across hbb/obb/poly."""
    assert mode in ("iou", "iof")
    b1, b2 = _to_np(bboxes1), _to_np(bboxes2)
    t1, t2 = get_bbox_type(b1), get_bbox_type(b2)
    assert t1 != "notype" and t2 != "notype"
    rows, cols = b1.shape[0], b2.shape[0]
    if is_aligned:
        assert rows == cols
    if rows * cols == 0:
        return np.zeros((rows, 1) if is_aligned else (rows, cols),
                        np.float32)

    h1, h2 = _as_hbb(b1, t1), _as_hbb(b2, t2)
    if not is_aligned:
        h1 = h1[:, None, :]
    lt = np.maximum(h1[..., :2], h2[..., :2])
    rb = np.minimum(h1[..., 2:], h2[..., 2:])
    wh = np.clip(rb - lt, 0, None)
    h_inter = wh[..., 0] * wh[..., 1]

    if t1 == "hbb" and t2 == "hbb":
        inter = h_inter
        a1 = (h1[..., 2] - h1[..., 0]) * (h1[..., 3] - h1[..., 1])
        if mode == "iou":
            a2 = (h2[..., 2] - h2[..., 0]) * (h2[..., 3] - h2[..., 1])
            union = a1 + a2 - inter
        else:
            union = a1
    else:
        p1 = _as_poly(b1, t1)
        p2 = _as_poly(b2, t2)
        a1 = bbox_areas(p1)
        a2 = bbox_areas(p2)
        inter = np.zeros(h_inter.shape, np.float32)
        for idx in zip(*np.nonzero(h_inter)):
            i, j = idx[0], idx[-1]
            iou = float(iou_poly_single(p1[i], p2[j]))
            # recover the raw intersection area from the pairwise IoU
            inter[idx] = iou * (a1[i] + a2[j]) / (1.0 + iou) \
                if iou > 0 else 0.0
        if mode == "iou":
            if is_aligned:
                union = a1 + a2 - inter[..., 0] \
                    if inter.ndim > 1 else a1 + a2 - inter
                union = union.reshape(inter.shape)
            else:
                union = a1[:, None] + a2[None, :] - inter
        else:
            union = a1 if is_aligned else a1[:, None]

    out = inter / np.clip(union, eps, None)
    if out.ndim == 1:
        out = out[..., None]
    return out.astype(np.float32)


def bbox_areas(bboxes):
    """Areas for hbb (x1y1x2y2), obb (cx cy w h t) or poly (8)."""
    b = _to_np(bboxes)
    btype = get_bbox_type(b)
    assert btype != "notype"
    if btype == "hbb":
        return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    if btype == "obb":
        return b[..., 2] * b[..., 3]
    pts = b.reshape(*b.shape[:-1], 4, 2)
    area = np.zeros(b.shape[:-1], np.float32)
    for i in range(4):
        j = (i + 1) % 4
        area += 0.5 * (pts[..., i, 0] * pts[..., j, 1]
                       - pts[..., j, 0] * pts[..., i, 1])
    return np.abs(area)


def _greedy_nms(bboxes, order, iou_thr):
    keep = []
    order = list(order)
    bboxes = _to_np(bboxes)
    while order:
        i = order.pop(0)
        keep.append(i)
        if not order:
            break
        ious = bbox_overlaps(bboxes[[i]], bboxes[np.asarray(order)])[0]
        order = [o for o, v in zip(order, ious) if v <= iou_thr]
    return np.asarray(keep, np.int64)


def bbox_nms(bboxes, scores, iou_thr=0.5, score_thr=0.01):
    """Score-ordered greedy NMS over any box type."""
    scores = _to_np(scores)
    order = scores.argsort()[::-1]
    order = order[scores[order] > score_thr]
    return _greedy_nms(bboxes, order, iou_thr)


def bbox_area_nms(bboxes, iou_thr=0.5):
    """Area-ordered greedy NMS (largest kept first)."""
    order = bbox_areas(bboxes).argsort()[::-1]
    return _greedy_nms(bboxes, order, iou_thr)
