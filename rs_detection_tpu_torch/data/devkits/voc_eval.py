"""VOC-style AP of oriented detections (counterpart of
``rs_detection_tpu/data/devkits/voc_eval.py``): ``voc_ap``, 11-point or
the area under the monotone precision envelope, and ``voc_eval_dota``,
greedy matching by score with an hbb prefilter (the VOC +1 pixel
convention) and the exact polygon IoU of ``ops/nms_poly.py`` on the
candidates; a detection matched to a difficult ground truth counts as
neither a true nor a false positive."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ...ops.nms_poly import iou_poly_single


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from recall and precision at each detection, in score order."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_dota(dets: np.ndarray, gts: Dict,
                  iou_func: Optional[Callable] = None, ovthresh: float = 0.5,
                  use_07_metric: bool = False):
    """``dets``: [N, 10] rows (image index, 8 polygon coordinates,
    score). ``gts``: {image index: {"box": [M, 8] polygons, "det": [M]
    matched flags (updated in place), "difficult": [M] bool}}.
    ``iou_func``: IoU of two polygons (the exact host one by default).
    Returns (recall, precision, ap)."""
    if iou_func is None:
        iou_func = iou_poly_single
    dets = np.asarray(dets, np.float64)
    npos = sum(int((~g["difficult"]).sum()) for g in gts.values())
    nd = len(dets)
    if nd == 0 or npos == 0:
        return 0.0, 0.0, 0.0

    order = np.argsort(-dets[:, -1])
    dets = dets[order, :-1]

    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d, det in enumerate(dets):
        bb = det[1:9]
        r = gts.get(int(det[0]))
        ovmax, jmax = -np.inf, -1
        if r is not None and r["box"].size > 0:
            bbgt = r["box"].astype(np.float64)
            gx1 = bbgt[:, 0::2].min(1)
            gy1 = bbgt[:, 1::2].min(1)
            gx2 = bbgt[:, 0::2].max(1)
            gy2 = bbgt[:, 1::2].max(1)
            bx1, by1 = bb[0::2].min(), bb[1::2].min()
            bx2, by2 = bb[0::2].max(), bb[1::2].max()
            iw = np.maximum(np.minimum(gx2, bx2)
                            - np.maximum(gx1, bx1) + 1.0, 0.0)
            ih = np.maximum(np.minimum(gy2, by2)
                            - np.maximum(gy1, by1) + 1.0, 0.0)
            inter = iw * ih
            uni = ((bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
                   + (gx2 - gx1 + 1.0) * (gy2 - gy1 + 1.0) - inter)
            cand = np.where(inter / uni > 0)[0]
            if cand.size:
                ious = [iou_func(bbgt[j], bb) for j in cand]
                k = int(np.argmax(ious))
                ovmax = ious[k]
                jmax = cand[k]
        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not r["det"][jmax]:
                    tp[d] = 1.0
                    r["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
