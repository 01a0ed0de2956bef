"""Extended box transforms (counterpart of
``rs_detection_tpu/ops/bbox_transforms.py``): the legacy rotated delta
coders (``_v2``, ``_v3``), the best-match selection of rotated rois and
ground truths, ``hbb2obb_v2`` and ``roi2droi``, the mask-to-polygon path
(``mask2poly``, ``gt_mask_bp_obbs``) and ``dbbox2result``.

The coders and selections compute on tensors; given numpy arrays they
compute on tensors made from them and give numpy arrays back, as the
JAX functions take either namespace. The mask path and
``polygonToRotRectangle_batch`` / ``dbbox2result`` are host numpy, as in
the JAX package. ``mask2poly_single`` is OpenCV's ``findContours``
(external borders, simple chains), ``contourArea``, ``minAreaRect`` and
``boxPoints`` without OpenCV (``ops/min_area_rect.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .box_ops import PI, norm_angle, poly_to_rotated_box_np, regular_theta
from .min_area_rect import mask_min_area_rect_points


def _tensor_in(fn):
    """Run ``fn`` on tensors: numpy array arguments become tensors, and
    the result goes back to numpy if any argument was an array."""
    @functools.wraps(fn)
    def call(*args, **kw):
        arrays = any(isinstance(a, np.ndarray) for a in args)
        out = fn(*(torch.from_numpy(np.ascontiguousarray(a))
                   if isinstance(a, np.ndarray) else a for a in args), **kw)
        return out.numpy() if arrays else out
    return call


def _consts(values, like):
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


@_tensor_in
def hbb2obb_v2(boxes):
    """hbb -> (cx, cy, w + 1, h + 1, -pi/2)."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    return torch.stack([cx, cy, w, h, torch.full_like(cx, -PI / 2)], -1)


def _delta_v2(proposals, gt):
    pw, ph, pa = proposals[..., 2], proposals[..., 3], proposals[..., 4]
    c, s = torch.cos(pa), torch.sin(pa)
    ox = gt[..., 0] - proposals[..., 0]
    oy = gt[..., 1] - proposals[..., 1]
    dx = (c * ox + s * oy) / pw
    dy = (-s * ox + c * oy) / ph
    dw = torch.log(torch.clamp(gt[..., 2], min=1e-6) / pw)
    dh = torch.log(torch.clamp(gt[..., 3], min=1e-6) / ph)
    da = torch.remainder(gt[..., 4] - pa, 2 * PI) / (2 * PI)
    return torch.stack([dx, dy, dw, dh, da], -1)


@_tensor_in
def dbbox2delta_v2(proposals, gt, means=(0.,) * 5, stds=(1.,) * 5):
    """Rotated deltas, v2: (dx, dy) in the proposal's frame, the angle's
    difference mod 2 pi over 2 pi."""
    d = _delta_v2(proposals, gt)
    return (d - _consts(means, d)) / _consts(stds, d)


def _decode_v2(rois, d, wh_ratio_clip):
    max_ratio = abs(math.log(wh_ratio_clip))
    pw, ph, pa = rois[..., 2], rois[..., 3], rois[..., 4]
    c, s = torch.cos(pa), torch.sin(pa)
    gx = d[..., 0] * pw * c - d[..., 1] * ph * s + rois[..., 0]
    gy = d[..., 0] * pw * s + d[..., 1] * ph * c + rois[..., 1]
    gw = pw * torch.exp(torch.clamp(d[..., 2], -max_ratio, max_ratio))
    gh = ph * torch.exp(torch.clamp(d[..., 3], -max_ratio, max_ratio))
    ga = d[..., 4] * 2 * PI + pa
    return torch.stack([gx, gy, gw, gh, ga], -1)


@_tensor_in
def delta2dbbox_v2(rois, deltas, means=(0.,) * 5, stds=(1.,) * 5,
                   wh_ratio_clip=16 / 1000):
    """Inverse of ``dbbox2delta_v2`` (w, h ratios clipped)."""
    d = deltas * _consts(stds, deltas) + _consts(means, deltas)
    return _decode_v2(rois, d, wh_ratio_clip)


def _delta_v3(proposals, gt, means, stds):
    base = _delta_v2(proposals, gt)
    da = regular_theta(gt[..., 4] - proposals[..., 4]) / (2 * PI)
    d = torch.cat([base[..., :4], da[..., None]], -1)
    return (d - _consts(means, d)) / _consts(stds, d)


@_tensor_in
def dbbox2delta_v3(proposals, gt, means=(0.,) * 5, stds=(1.,) * 5):
    """v3: as v2, the angle's difference wrapped into [-pi/2, pi/2)
    over 2 pi."""
    return _delta_v3(proposals, gt, means, stds)


@_tensor_in
def delta2dbbox_v3(rois, deltas, means=(0.,) * 5, stds=(1.,) * 5,
                   wh_ratio_clip=16 / 1000):
    """Inverse of ``dbbox2delta_v3``: the box as v2 decodes it with a zero
    angle delta (and v2's default ratio clip, as JAX calls it), the angle
    ``da * 2 pi + roi angle``."""
    d = deltas * _consts(stds, deltas) + _consts(means, deltas)
    out = _decode_v2(rois, torch.cat([d[..., :4],
                                      torch.zeros_like(d[..., 4:5])], -1),
                     16 / 1000)
    ga = d[..., 4] * 2 * PI + rois[..., 4]
    return torch.cat([out[..., :4], ga[..., None]], -1)


def _best_match(rrois, gt_rois):
    gx, gy, gw, gh, ga = gt_rois.unbind(-1)
    cands = torch.stack([
        torch.stack([gx, gy, gw if k % 2 == 0 else gh,
                     gh if k % 2 == 0 else gw, ga + k * PI / 2.0], -1)
        for k in range(4)])                               # [4, ..., 5]
    diff = torch.abs(regular_theta(cands[..., 4] - rrois[..., 4][None]))
    best = torch.argmin(diff, dim=0)
    return torch.take_along_dim(cands, best[None, ..., None], dim=0)[0]


@_tensor_in
def choose_best_match_batch(rrois, gt_rois):
    """Each ground truth in the one of its four (theta + k pi/2) forms
    whose angle is nearest the rroi's (the first on a tie)."""
    return _best_match(rrois, gt_rois)


@_tensor_in
def best_match_dbbox2delta(rrois, gt, means=(0.,) * 5, stds=(1.,) * 5):
    """``dbbox2delta_v3`` against the best-matching ground-truth form."""
    return _delta_v3(rrois, _best_match(rrois, gt), means, stds)


@_tensor_in
def choose_best_Rroi_batch(rrois):
    """rrois with w >= h, theta in [-pi/4, 3pi/4)."""
    x, y, w, h, t = rrois.unbind(-1)
    swap = w < h
    return torch.stack([x, y, torch.where(swap, h, w),
                        torch.where(swap, w, h),
                        norm_angle(torch.where(swap, t + PI / 2, t), "le135")],
                       -1)


def choose_best_obb_batch(obbs):
    """``choose_best_Rroi_batch`` (the same normalization)."""
    return choose_best_Rroi_batch(obbs)


@_tensor_in
def roi2droi(rois):
    """hbb rois (idx, x1, y1, x2, y2) -> (idx, cx, cy, w + 1, h + 1,
    -pi/2)."""
    return torch.cat([rois[:, :1], hbb2obb_v2(rois[:, 1:5])], 1)


def polygonToRotRectangle_batch(polys, with_module=True):
    """8-coordinate polygons -> (cx, cy, w, h, theta) by their edges, host
    numpy; ``with_module`` normalizes theta into [-pi/4, 3pi/4) (le135),
    else [-pi/2, pi/2)."""
    return poly_to_rotated_box_np(polys, "le135" if with_module else "le90")


def mask2poly_single(binary_mask):
    """A binary mask -> the [4, 2] f32 corners of the minimum-area rectangle
    of its largest external contour, in ``cv2.boxPoints``' order (zeros
    for an empty mask); host numpy."""
    return mask_min_area_rect_points(binary_mask)


def mask2poly(binary_mask_list):
    return [mask2poly_single(m) for m in binary_mask_list]


def gt_mask_bp_obbs(gt_masks, with_module=True):
    """Ground-truth masks -> obbs through ``mask2poly`` and the edge fit."""
    polys = np.stack([p.reshape(-1) for p in mask2poly(gt_masks)])
    return polygonToRotRectangle_batch(polys, with_module)


def gt_mask_bp_obbs_list(gt_masks_list):
    return [gt_mask_bp_obbs(m) for m in gt_masks_list]


def dbbox2result(dbboxes, labels, num_classes):
    """Detections split into per-class arrays (``num_classes`` counts the
    background), host numpy."""
    dbboxes = np.asarray(dbboxes)
    labels = np.asarray(labels)
    return [dbboxes[labels == i] for i in range(num_classes - 1)]
