"""The classic (py-faster-rcnn style) target and proposal creators
(counterpart of ``rs_detection_tpu/models/roi_heads/legacy_creators.py``):
``AnchorTargetCreator``, ``ProposalCreator``, ``ProposalTargetCreator``
and the ``bbox2loc`` / ``loc2bbox`` / ``bbox_iou`` helpers. No network of
either package uses them; they are host numpy utilities, as in the JAX
package, and the port's networks assign and sample with
``models/boxes/``. The creators draw from ``rng`` (the global
``np.random`` by default, or a ``np.random.Generator``), so the same
generator gives the JAX package's draws bit for bit.
"""

from __future__ import annotations

import numpy as np


def bbox2loc(src, dst, mean=(0., 0., 0., 0.), std=(1., 1., 1., 1.)):
    """hbb (x1 y1 x2 y2) pairs -> (dx, dy, dw, dh) deltas."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    w = np.maximum(src[:, 2] - src[:, 0], 1e-6)
    h = np.maximum(src[:, 3] - src[:, 1], 1e-6)
    cx = src[:, 0] + 0.5 * w
    cy = src[:, 1] + 0.5 * h
    gw = np.maximum(dst[:, 2] - dst[:, 0], 1e-6)
    gh = np.maximum(dst[:, 3] - dst[:, 1], 1e-6)
    gx = dst[:, 0] + 0.5 * gw
    gy = dst[:, 1] + 0.5 * gh
    loc = np.stack([(gx - cx) / w, (gy - cy) / h,
                    np.log(gw / w), np.log(gh / h)], 1)
    return (loc - np.asarray(mean, np.float32)) / np.asarray(std,
                                                             np.float32)


def loc2bbox(src, loc, mean=(0., 0., 0., 0.), std=(1., 1., 1., 1.)):
    """Inverse of :func:`bbox2loc`."""
    src = np.asarray(src, np.float32)
    loc = np.asarray(loc, np.float32) * np.asarray(std, np.float32) \
        + np.asarray(mean, np.float32)
    w = src[:, 2] - src[:, 0]
    h = src[:, 3] - src[:, 1]
    cx = src[:, 0] + 0.5 * w
    cy = src[:, 1] + 0.5 * h
    gx = cx + loc[:, 0] * w
    gy = cy + loc[:, 1] * h
    gw = w * np.exp(loc[:, 2])
    gh = h * np.exp(loc[:, 3])
    return np.stack([gx - 0.5 * gw, gy - 0.5 * gh,
                     gx + 0.5 * gw, gy + 0.5 * gh], 1)


def bbox_iou(a, b):
    """[N, 4] x [M, 4] hbb IoU -> [N, M]."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ar_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ar_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(ar_a[:, None] + ar_b[None, :] - inter,
                              1e-6)


def _unmap(data, count, index, fill=0):
    shape = (count,) + data.shape[1:]
    out = np.full(shape, fill, data.dtype)
    out[index] = data
    return out


class AnchorTargetCreator:
    """Assign GT to anchors with pos/neg subsampling (reference
    ``anchor_generator.py:220-332``). Returns (loc [S, 4], label [S]
    with 1=pos / 0=neg / -1=ignore)."""

    def __init__(self, n_sample=256, pos_iou_thresh=0.7,
                 neg_iou_thresh=0.3, pos_ratio=0.5, rng=None):
        self.n_sample = n_sample
        self.pos_iou_thresh = pos_iou_thresh
        self.neg_iou_thresh = neg_iou_thresh
        self.pos_ratio = pos_ratio
        self.rng = rng or np.random

    def __call__(self, bbox, anchor, img_size):
        img_w, img_h = img_size
        anchor = np.asarray(anchor, np.float32)
        bbox = np.asarray(bbox, np.float32)
        n_anchor = len(anchor)
        inside = np.where((anchor[:, 0] >= 0) & (anchor[:, 1] >= 0)
                          & (anchor[:, 2] <= img_w)
                          & (anchor[:, 3] <= img_h))[0]
        anc = anchor[inside]
        argmax_ious, label = self._create_label(anc, bbox)
        loc = bbox2loc(anc, bbox[argmax_ious])
        label = _unmap(label, n_anchor, inside, fill=-1)
        loc = _unmap(loc, n_anchor, inside, fill=0)
        return loc, label

    def _create_label(self, anchor, bbox):
        label = -np.ones((anchor.shape[0],), np.int32)
        ious = bbox_iou(anchor, bbox)
        argmax_ious = ious.argmax(1)
        max_ious = ious[np.arange(len(anchor)), argmax_ious]
        gt_max_ious = ious.max(0)
        gt_argmax_ious = np.where((ious == gt_max_ious).any(1))[0]

        label[max_ious < self.neg_iou_thresh] = 0
        label[gt_argmax_ious] = 1
        label[max_ious >= self.pos_iou_thresh] = 1

        n_pos = int(self.pos_ratio * self.n_sample)
        pos = np.where(label == 1)[0]
        if len(pos) > n_pos:
            label[self.rng.choice(pos, len(pos) - n_pos,
                                  replace=False)] = -1
        n_neg = self.n_sample - (label == 1).sum()
        neg = np.where(label == 0)[0]
        if len(neg) > n_neg:
            label[self.rng.choice(neg, len(neg) - n_neg,
                                  replace=False)] = -1
        return argmax_ious, label


class ProposalCreator:
    """Decode + clip + min-size filter + NMS proposal generation
    (reference ``anchor_generator.py:335-443``)."""

    def __init__(self, nms_thresh=0.7, n_train_pre_nms=12000,
                 n_train_post_nms=2000, n_test_pre_nms=6000,
                 n_test_post_nms=300, min_size=16):
        self.nms_thresh = nms_thresh
        self.n_train_pre_nms = n_train_pre_nms
        self.n_train_post_nms = n_train_post_nms
        self.n_test_pre_nms = n_test_pre_nms
        self.n_test_post_nms = n_test_post_nms
        self.min_size = min_size

    def __call__(self, loc, score, anchor, img_size, training=False):
        n_pre = self.n_train_pre_nms if training else self.n_test_pre_nms
        n_post = (self.n_train_post_nms if training
                  else self.n_test_post_nms)
        roi = loc2bbox(np.asarray(anchor, np.float32),
                       np.asarray(loc, np.float32))
        roi[:, 0::2] = np.clip(roi[:, 0::2], 0, img_size[0])
        roi[:, 1::2] = np.clip(roi[:, 1::2], 0, img_size[1])
        ws = roi[:, 2] - roi[:, 0]
        hs = roi[:, 3] - roi[:, 1]
        keep = np.where((hs >= self.min_size) & (ws >= self.min_size))[0]
        roi = roi[keep]
        score = np.asarray(score, np.float32)[keep]
        order = score.argsort()[::-1]
        if n_pre > 0:
            order = order[:n_pre]
        roi, score = roi[order], score[order]
        keep = self._nms(roi, score)
        if n_post > 0:
            keep = keep[:n_post]
        return roi[keep]

    def _nms(self, roi, score):
        order = list(range(len(roi)))       # already score-sorted
        keep = []
        while order:
            i = order.pop(0)
            keep.append(i)
            if not order:
                break
            ious = bbox_iou(roi[[i]], roi[np.asarray(order)])[0]
            order = [o for o, v in zip(order, ious)
                     if v <= self.nms_thresh]
        return np.asarray(keep, np.int64)


class ProposalTargetCreator:
    """Sample rois + GT targets for the classic second stage
    (reference ``anchor_generator.py:445-551``). Returns
    (sample_roi [S, 4], gt_roi_loc [S, 4], gt_roi_label [S] with 0 =
    background, 1..L = foreground)."""

    def __init__(self, n_sample=128, pos_ratio=0.25, pos_iou_thresh=0.5,
                 neg_iou_thresh_hi=0.5, neg_iou_thresh_lo=0.0, rng=None):
        self.n_sample = n_sample
        self.pos_ratio = pos_ratio
        self.pos_iou_thresh = pos_iou_thresh
        self.neg_iou_thresh_hi = neg_iou_thresh_hi
        self.neg_iou_thresh_lo = neg_iou_thresh_lo
        self.rng = rng or np.random

    def __call__(self, roi, bbox, label):
        roi = np.asarray(roi, np.float32)
        bbox = np.asarray(bbox, np.float32)
        label = np.asarray(label, np.int64)
        n_pos_max = int(round(self.n_sample * self.pos_ratio))
        iou = bbox_iou(roi, bbox)
        gt_assignment = iou.argmax(1)
        max_iou = iou[np.arange(len(roi)), gt_assignment]
        gt_roi_label = label[gt_assignment] + 1   # 0 = background

        pos = np.where(max_iou >= self.pos_iou_thresh)[0]
        n_pos = min(n_pos_max, len(pos))
        if len(pos) > 0:
            pos = self.rng.choice(pos, n_pos, replace=False)
        neg = np.where((max_iou < self.neg_iou_thresh_hi)
                       & (max_iou >= self.neg_iou_thresh_lo))[0]
        n_neg = min(self.n_sample - n_pos, len(neg))
        if len(neg) > 0:
            neg = self.rng.choice(neg, n_neg, replace=False)

        keep = np.concatenate([pos, neg]).astype(np.int64)
        gt_roi_label = gt_roi_label[keep]
        gt_roi_label[n_pos:] = 0
        sample_roi = roi[keep]
        gt_roi_loc = bbox2loc(sample_roi, bbox[gt_assignment[keep]])
        return sample_roi, gt_roi_loc, gt_roi_label
