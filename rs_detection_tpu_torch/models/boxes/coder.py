"""Box delta decoders of Oriented R-CNN inference (counterpart of the
decode halves in ``rs_detection_tpu/models/boxes/coder.py``)."""

from __future__ import annotations

import math

import torch

from ...ops import box_ops as B


def _affine(deltas, means, stds, dim: int):
    k = deltas.shape[-1] // dim
    means_t = torch.tensor(means, dtype=deltas.dtype,
                           device=deltas.device).repeat(k)
    stds_t = torch.tensor(stds, dtype=deltas.dtype,
                          device=deltas.device).repeat(k)
    return deltas * stds_t + means_t, k


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


class MidpointOffsetCoder:
    def __init__(self, target_means=(0.,) * 6, target_stds=(1.,) * 6):
        self.means = tuple(target_means)
        self.stds = tuple(target_stds)

    def decode(self, bboxes, pred_bboxes, wh_ratio_clip: float = 16 / 1000):
        return midpoint_offset_decode(bboxes, pred_bboxes, self.means,
                                      self.stds, wh_ratio_clip)


class OrientedDeltaXYWHTCoder:
    def __init__(self, target_means=(0.,) * 5, target_stds=(1.,) * 5):
        self.means = tuple(target_means)
        self.stds = tuple(target_stds)

    def decode(self, bboxes, pred_bboxes, wh_ratio_clip: float = 16 / 1000):
        return oriented_delta_decode(bboxes, pred_bboxes, self.means,
                                     self.stds, wh_ratio_clip)
