"""Box delta coders of Oriented R-CNN (counterpart of
``MidpointOffsetCoder`` and ``OrientedDeltaXYWHTCoder`` in
``rs_detection_tpu/models/boxes/coder.py``): the encoders make the
training targets, the decoders the proposals and detections."""

from __future__ import annotations

import math

import torch

from ...ops import box_ops as B
from ...utils.registry import BOXES


def _affine(deltas, means, stds, dim: int):
    k = deltas.shape[-1] // dim
    means_t = torch.tensor(means, dtype=deltas.dtype,
                           device=deltas.device).repeat(k)
    stds_t = torch.tensor(stds, dtype=deltas.dtype,
                          device=deltas.device).repeat(k)
    return deltas * stds_t + means_t, k


def _normalize(deltas, means, stds):
    means_t = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds_t = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means_t) / stds_t


def midpoint_offset_encode(bboxes, gt_obbs, means, stds):
    """Oriented RPN 6-dim targets: hbb deltas of the gt's enclosing box
    against the hbb anchor, then the x of the gt's topmost vertex and
    the y of its rightmost vertex, as offsets from the centre over the
    enclosing box's width and height."""
    px = (bboxes[..., 0] + bboxes[..., 2]) * 0.5
    py = (bboxes[..., 1] + bboxes[..., 3]) * 0.5
    pw = bboxes[..., 2] - bboxes[..., 0]
    ph = bboxes[..., 3] - bboxes[..., 1]
    hbb = B.obb2hbb(gt_obbs)
    poly = B.obb2poly(gt_obbs)
    gx = (hbb[..., 0] + hbb[..., 2]) * 0.5
    gy = (hbb[..., 1] + hbb[..., 3]) * 0.5
    gw = hbb[..., 2] - hbb[..., 0]
    gh = hbb[..., 3] - hbb[..., 1]
    xs, ys = poly[..., 0::2], poly[..., 1::2]
    y_min = ys.amin(-1, keepdim=True)
    x_max = xs.amax(-1, keepdim=True)
    # a 0.1 px band picks the vertex; ties go to the larger coordinate
    ga = torch.where((ys - y_min).abs() > 0.1, -1000.0, xs).amax(-1)
    gb = torch.where((xs - x_max).abs() > 0.1, -1000.0, ys).amax(-1)
    deltas = torch.stack(
        [(gx - px) / pw, (gy - py) / ph,
         torch.log(gw.clamp(min=1e-6) / pw), torch.log(gh.clamp(min=1e-6) / ph),
         (ga - gx) / gw, (gb - gy) / gh], dim=-1)
    return _normalize(deltas, means, stds)


def midpoint_offset_decode(bboxes, deltas, means, stds,
                           wh_ratio_clip: float = 16 / 1000):
    """Oriented RPN decode: rebuild the quad from the hbb and the
    midpoint offsets, rescale the vertices radially so all four
    diagonals equal the longest, then ``rectpoly2obb``."""
    d, k = _affine(deltas, means, stds, 6)
    dx, dy = d[..., 0::6], d[..., 1::6]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = torch.clamp(d[..., 2::6], -max_ratio, max_ratio)
    dh = torch.clamp(d[..., 3::6], -max_ratio, max_ratio)
    da = torch.clamp(d[..., 4::6], -0.5, 0.5)
    db = torch.clamp(d[..., 5::6], -0.5, 0.5)

    px = ((bboxes[..., 0] + bboxes[..., 2]) * 0.5)[..., None]
    py = ((bboxes[..., 1] + bboxes[..., 3]) * 0.5)[..., None]
    pw = (bboxes[..., 2] - bboxes[..., 0])[..., None]
    ph = (bboxes[..., 3] - bboxes[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1, y1 = gx - gw * 0.5, gy - gh * 0.5
    x2, y2 = gx + gw * 0.5, gy + gh * 0.5
    ga = gx + da * gw
    _ga = gx - da * gw
    gb = gy + db * gh
    _gb = gy - db * gh

    polys = torch.stack([ga, y1, x2, gb, _ga, y2, x1, _gb], dim=-1)
    center = torch.stack([gx, gy] * 4, dim=-1)
    rel = polys - center
    diag = torch.sqrt(rel[..., 0::2] ** 2 + rel[..., 1::2] ** 2)
    scale = diag.amax(-1, keepdim=True) / torch.clamp(diag, min=1e-6)
    rel = rel * torch.repeat_interleave(scale, 2, dim=-1)
    obb = B.rectpoly2obb(rel + center)                  # [..., K, 5]
    return obb.reshape(*deltas.shape[:-1], -1) if k > 1 else obb[..., 0, :]


def oriented_delta_encode(rois, gts, means, stds):
    """Stage-2 obb targets in the roi's rotated frame: the gt angle
    offset of the two (mod pi/2) closest to 0, with w/h swapped to
    match."""
    px, py, pw, ph, pt = rois.unbind(-1)
    gx, gy, gw, gh, gt = gts.unbind(-1)
    d1 = B.regular_theta(gt - pt)
    d2 = B.regular_theta(gt - pt + math.pi / 2)
    pick1 = d1.abs() < d2.abs()
    gw_r = torch.where(pick1, gw, gh)
    gh_r = torch.where(pick1, gh, gw)
    dtheta = torch.where(pick1, d1, d2)
    c, s = torch.cos(-pt), torch.sin(-pt)
    ox, oy = gx - px, gy - py
    deltas = torch.stack(
        [(c * ox + s * oy) / pw, (-s * ox + c * oy) / ph,
         torch.log(gw_r.clamp(min=1e-6) / pw),
         torch.log(gh_r.clamp(min=1e-6) / ph), dtheta], dim=-1)
    return _normalize(deltas, means, stds)


def oriented_delta_decode(rois, deltas, means, stds,
                          wh_ratio_clip: float = 16 / 1000):
    """Stage-2 obb decode in the roi's rotated frame."""
    d, k = _affine(deltas, means, stds, 5)
    dx, dy = d[..., 0::5], d[..., 1::5]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = torch.clamp(d[..., 2::5], -max_ratio, max_ratio)
    dh = torch.clamp(d[..., 3::5], -max_ratio, max_ratio)
    dtheta = d[..., 4::5]
    px, py, pw, ph, pt = (rois[..., i][..., None] for i in range(5))
    c, s = torch.cos(-pt), torch.sin(-pt)
    gx = dx * pw * c - dy * ph * s + px
    gy = dx * pw * s + dy * ph * c + py
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gtheta = B.regular_theta(dtheta + pt)
    obb = B.regular_obb(torch.stack([gx, gy, gw, gh, gtheta], dim=-1))
    return obb.reshape(deltas.shape) if k > 1 else obb[..., 0, :]


@BOXES.register_module()
class MidpointOffsetCoder:
    def __init__(self, target_means=(0.,) * 6, target_stds=(1.,) * 6):
        self.means = tuple(target_means)
        self.stds = tuple(target_stds)

    def encode(self, bboxes, gt_bboxes):
        return midpoint_offset_encode(bboxes, gt_bboxes, self.means,
                                      self.stds)

    def decode(self, bboxes, pred_bboxes, wh_ratio_clip: float = 16 / 1000):
        return midpoint_offset_decode(bboxes, pred_bboxes, self.means,
                                      self.stds, wh_ratio_clip)


@BOXES.register_module()
class OrientedDeltaXYWHTCoder:
    def __init__(self, target_means=(0.,) * 5, target_stds=(1.,) * 5):
        self.means = tuple(target_means)
        self.stds = tuple(target_stds)

    def encode(self, bboxes, gt_bboxes):
        return oriented_delta_encode(bboxes, gt_bboxes, self.means,
                                     self.stds)

    def decode(self, bboxes, pred_bboxes, wh_ratio_clip: float = 16 / 1000):
        return oriented_delta_decode(bboxes, pred_bboxes, self.means,
                                     self.stds, wh_ratio_clip)
