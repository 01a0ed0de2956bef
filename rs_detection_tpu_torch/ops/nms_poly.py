"""Polygon NMS and exact polygon IoU on the host (counterpart of the host
part of ``rs_detection_tpu/ops/nms_poly.py``): Sutherland-Hodgman convex
clipping and the shoelace area in numpy, the greedy NMS with an hbb
prefilter of the tile merge (``poly_nms_numpy``), and its native C++ core
(``poly_nms``, ``native/poly_nms.cc``), which the merge runs.
"""

from __future__ import annotations

import numpy as np

from ..native import poly_nms_native


def clip_polygons(subject: np.ndarray, valid_counts: np.ndarray,
                  clip_quad: np.ndarray):
    """Sutherland–Hodgman: clip N padded polygons by one convex quad.

    Args:
      subject: [N, K, 2] polygon vertices (padded).
      valid_counts: [N] number of real vertices per polygon.
      clip_quad: [4, 2] convex clip polygon (CCW or CW both fine).

    Returns:
      (vertices [N, K + 4, 2], counts [N]) of the clipped polygons.
    """
    n, k0, _ = subject.shape
    kmax = k0 + 4  # each clip edge can add at most one vertex
    verts = np.zeros((n, kmax, 2), np.float64)
    verts[:, :k0] = subject
    counts = valid_counts.astype(np.int64).copy()

    # ensure CCW orientation of clip quad for a consistent inside test
    area2 = 0.0
    for i in range(4):
        a, b = clip_quad[i], clip_quad[(i + 1) % 4]
        area2 += a[0] * b[1] - b[0] * a[1]
    quad = clip_quad if area2 >= 0 else clip_quad[::-1]

    for e in range(4):
        a = quad[e]
        b = quad[(e + 1) % 4]
        ex, ey = b[0] - a[0], b[1] - a[1]

        new_verts = np.zeros_like(verts)
        new_counts = np.zeros_like(counts)
        idx = np.arange(kmax)
        cur = verts
        nxt = np.take_along_axis(
            verts, ((idx + 1) % np.maximum(counts, 1)[:, None])[..., None]
            .repeat(2, -1), axis=1)
        # signed side of each vertex wrt edge (>=0 is inside for CCW)
        side_cur = (ex * (cur[..., 1] - a[1]) - ey * (cur[..., 0] - a[0]))
        side_nxt = (ex * (nxt[..., 1] - a[1]) - ey * (nxt[..., 0] - a[0]))
        active = idx[None, :] < counts[:, None]

        denom = side_cur - side_nxt
        denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        t = side_cur / denom
        inter = cur + t[..., None] * (nxt - cur)

        for i in range(n):
            if counts[i] == 0:
                continue
            out = []
            for j in range(counts[i]):
                c_in = side_cur[i, j] >= 0
                n_in = side_nxt[i, j] >= 0
                if c_in:
                    out.append(cur[i, j])
                    if not n_in:
                        out.append(inter[i, j])
                elif n_in:
                    out.append(inter[i, j])
            new_counts[i] = len(out)
            if out:
                new_verts[i, :len(out)] = np.asarray(out)
        verts, counts = new_verts, new_counts
        _ = active  # vectorized side computation reused per edge
    return verts, counts


def polygon_area(verts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Shoelace area of padded polygons [N, K, 2]."""
    n, kmax, _ = verts.shape
    areas = np.zeros((n,), np.float64)
    for i in range(n):
        c = counts[i]
        if c < 3:
            continue
        p = verts[i, :c]
        q = np.roll(p, -1, 0)
        areas[i] = 0.5 * abs(np.sum(p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]))
    return areas


def iou_poly_single(poly1, poly2) -> float:
    """Exact IoU of two quads (host). Parity: ``nms_poly.py:247``."""
    p1 = np.asarray(poly1, np.float64).reshape(4, 2)
    p2 = np.asarray(poly2, np.float64).reshape(4, 2)
    verts, counts = clip_polygons(p1[None], np.array([4]), p2)
    inter = polygon_area(verts, counts)[0]
    a1 = polygon_area(p1[None], np.array([4]))[0]
    a2 = polygon_area(p2[None], np.array([4]))[0]
    union = a1 + a2 - inter
    return float(inter / union) if union > 0 else 0.0


def iou_polys_np(query: np.ndarray, cands: np.ndarray) -> np.ndarray:
    """IoU of one quad against M quads (host). [8] x [M, 8] -> [M]."""
    q = np.asarray(query, np.float64).reshape(4, 2)
    c = np.asarray(cands, np.float64).reshape(-1, 4, 2)
    m = c.shape[0]
    if m == 0:
        return np.zeros((0,), np.float64)
    verts, counts = clip_polygons(c, np.full((m,), 4), q)
    inter = polygon_area(verts, counts)
    aq = polygon_area(q[None], np.array([4]))[0]
    ac = polygon_area(c, np.full((m,), 4))
    union = aq + ac - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def poly_nms_numpy(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy polygon NMS with hbb prefilter (host hot loop).

    Args:
      dets: [N, 9] = 8 poly coords + score.

    Returns kept indices, score-descending. The plain version of the
    native core (:func:`poly_nms`), which the tests hold it against.
    """
    dets = np.asarray(dets, np.float64)
    if dets.shape[0] == 0:
        return np.zeros((0,), np.int64)
    polys = dets[:, :8]
    scores = dets[:, 8]
    xs = polys[:, 0::2]
    ys = polys[:, 1::2]
    x1, y1 = xs.min(1), ys.min(1)
    x2, y2 = xs.max(1), ys.max(1)
    areas_h = (x2 - x1 + 1) * (y2 - y1 + 1)

    order = np.argsort(-scores)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        if rest.size == 0:
            break
        # hbb prefilter (VOC +1 convention, as in the reference)
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        hiou = w * h / (areas_h[i] + areas_h[rest] - w * h)
        cand = np.nonzero(hiou > 0)[0]
        ious = np.zeros(rest.shape, np.float64)
        if cand.size:
            ious[cand] = iou_polys_np(polys[i], polys[rest[cand]])
        order = rest[ious <= thresh]
    return np.asarray(keep, np.int64)


def poly_nms(dets, thresh: float) -> np.ndarray:
    """Greedy polygon NMS of ``dets`` [N, 9] in the native core: kept
    indices, score-descending, as :func:`poly_nms_numpy` gives them."""
    return poly_nms_native(np.asarray(dets, np.float64).reshape(-1, 9),
                           thresh)


def multiclass_poly_nms(multi_polys, multi_scores, score_thr, nms_thresh,
                        max_num=-1):
    """Per-class poly NMS over numpy quads [N, 8] and scores [N, C]
    (``poly_nms_numpy`` a class): (dets [K, 9] f32 with the score last,
    labels [K]) by descending score, at most ``max_num`` when
    positive."""
    polys_out, scores_out, labels_out = [], [], []
    num_classes = multi_scores.shape[1]
    for c in range(num_classes):
        mask = multi_scores[:, c] > score_thr
        if not mask.any():
            continue
        p = multi_polys[mask]
        s = multi_scores[mask, c]
        keep = poly_nms_numpy(np.concatenate([p, s[:, None]], 1), nms_thresh)
        polys_out.append(p[keep])
        scores_out.append(s[keep])
        labels_out.append(np.full((len(keep),), c, np.int64))
    if not polys_out:
        return np.zeros((0, 9), np.float32), np.zeros((0,), np.int64)
    polys = np.concatenate(polys_out, 0)
    scores = np.concatenate(scores_out, 0)
    labels = np.concatenate(labels_out, 0)
    order = np.argsort(-scores)
    if max_num > 0:
        order = order[:max_num]
    dets = np.concatenate([polys[order], scores[order, None]], 1)
    return dets.astype(np.float32), labels[order]
