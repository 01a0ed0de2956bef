"""Rotated-box algebra on torch tensors (the subset of
``rs_detection_tpu/ops/box_ops.py`` that Oriented R-CNN inference uses),
and the numpy conversions of the host-side data pipeline.

obb = (cx, cy, w, h, theta), theta in radians, OBBDetection convention
(``obb2poly`` rotates by R = [[cos, sin], [-sin, cos]]); hbb = (x0, y0,
x1, y1); poly = (x0, y0, ..., x3, y3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi
HALF_PI = PI / 2.0


def regular_theta(theta, mode: str = "180", start: float = -HALF_PI):
    """Wrap theta into [start, start + pi) (or 2*pi for mode='360')."""
    cycle = 2 * PI if mode == "360" else PI
    return torch.remainder(theta - start, cycle) + start


def regular_obb(obboxes):
    """Force w >= h by swapping (w, h) and rotating theta by pi/2."""
    x, y, w, h, theta = obboxes.unbind(-1)
    swap = w > h
    w_r = torch.where(swap, w, h)
    h_r = torch.where(swap, h, w)
    t_r = regular_theta(torch.where(swap, theta, theta + HALF_PI))
    return torch.stack([x, y, w_r, h_r, t_r], dim=-1)


def obb2poly(obboxes):
    cx, cy, w, h, theta = obboxes.unbind(-1)
    c, s = torch.cos(theta), torch.sin(theta)
    v1x, v1y = w / 2 * c, -w / 2 * s
    v2x, v2y = -h / 2 * s, -h / 2 * c
    px = torch.stack([cx + v1x + v2x, cx + v1x - v2x,
                      cx - v1x - v2x, cx - v1x + v2x], dim=-1)
    py = torch.stack([cy + v1y + v2y, cy + v1y - v2y,
                      cy - v1y - v2y, cy - v1y + v2y], dim=-1)
    return torch.stack([px, py], dim=-1).reshape(*obboxes.shape[:-1], 8)


def obb2hbb(obboxes):
    cx, cy, w, h, theta = obboxes.unbind(-1)
    c, s = torch.cos(theta), torch.sin(theta)
    xb = torch.abs(w / 2 * c) + torch.abs(h / 2 * s)
    yb = torch.abs(w / 2 * s) + torch.abs(h / 2 * c)
    return torch.stack([cx - xb, cy - yb, cx + xb, cy + yb], dim=-1)


def rectpoly2obb(polys):
    """Rectangular polygon -> obb: theta from the first edge (y
    negated), extents in that frame (bbox_transforms.py:578-608)."""
    theta = torch.atan2(-(polys[..., 3] - polys[..., 1]),
                        polys[..., 2] - polys[..., 0])
    c, s = torch.cos(theta), torch.sin(theta)
    x = polys[..., 0::2].mean(-1)
    y = polys[..., 1::2].mean(-1)
    pts = polys.reshape(*polys.shape[:-1], 4, 2)
    relx = pts[..., 0] - x[..., None]
    rely = pts[..., 1] - y[..., None]
    rx = relx * c[..., None] - rely * s[..., None]
    ry = relx * s[..., None] + rely * c[..., None]
    w = rx.amax(-1) - rx.amin(-1)
    h = ry.amax(-1) - ry.amin(-1)
    return regular_obb(torch.stack([x, y, w, h, theta], dim=-1))


# ---------------------------------------------------------------------------
# numpy, JDet convention (R = [[cos, -sin], [sin, cos]]), for the host-side
# data pipeline
# ---------------------------------------------------------------------------

def norm_angle(angle, angle_version: str = "le135"):
    """Normalize angles: le90 -> [-pi/2, pi/2); le135 -> [-pi/4, 3pi/4)."""
    lo = -HALF_PI if angle_version == "le90" else -PI / 4.0
    return (angle - lo) % PI + lo


def poly_to_rotated_box_np(polys, angle_version: str = "le90"):
    """Quadrilaterals [N, 8] -> (cx, cy, w, h, theta) [N, 5], f32: w is
    the longer of edges (p1, p2) / (p2, p3), theta follows it, the centre
    is the midpoint of p1 and p3."""
    p = np.asarray(polys, dtype=np.float32)
    if p.size == 0:
        return np.zeros((0, 5), dtype=np.float32)
    x1, y1, x2, y2, x3, y3, x4, y4 = (p[..., i] for i in range(8))
    edge1 = np.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    edge2 = np.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    angle1 = np.arctan2(y2 - y1, x2 - x1)
    angle2 = np.arctan2(y4 - y1, x4 - x1)
    angle = norm_angle(np.where(edge1 > edge2, angle1, angle2), angle_version)
    return np.stack([(x1 + x3) / 2.0, (y1 + y3) / 2.0,
                     np.maximum(edge1, edge2), np.minimum(edge1, edge2),
                     angle], axis=-1).astype(np.float32)


def _best_begin_point(polys):
    """Rotate each quad's vertex order to the cyclic shift nearest (summed
    distance) to its hbb's TL-TR-BR-BL corners."""
    pts = polys.reshape(*polys.shape[:-1], 4, 2)
    lo, hi = pts.min(axis=-2), pts.max(axis=-2)
    corners = np.stack([lo, np.stack([hi[..., 0], lo[..., 1]], -1), hi,
                        np.stack([lo[..., 0], hi[..., 1]], -1)], axis=-2)
    rots = np.stack([np.roll(pts, -k, axis=-2) for k in range(4)], axis=-3)
    dists = np.sqrt(((rots - corners[..., None, :, :]) ** 2).sum(-1)).sum(-1)
    best = np.argmin(dists, axis=-1)
    return np.take_along_axis(rots, best[..., None, None, None],
                              axis=-3).reshape(polys.shape)


def rotated_box_to_poly_np(rrects, angle_version: str = "le90"):
    """(cx, cy, w, h, theta) [N, 5] -> quadrilaterals [N, 8], f32, the
    corners (-w/2, -h/2), (w/2, -h/2), (w/2, h/2), (-w/2, h/2) rotated,
    then the best begin point (the same vertex set for le90 and le135)."""
    r = np.asarray(rrects, dtype=np.float32)
    if r.shape[0] == 0:
        return np.zeros((0, 8), dtype=np.float32)
    cx, cy, w, h, theta = (r[..., i] for i in range(5))
    c, s = np.cos(theta), np.sin(theta)
    lx = np.stack([-w / 2.0, w / 2.0, w / 2.0, -w / 2.0], axis=-1)
    ly = np.stack([-h / 2.0, -h / 2.0, h / 2.0, h / 2.0], axis=-1)
    px = c[..., None] * lx - s[..., None] * ly + cx[..., None]
    py = s[..., None] * lx + c[..., None] * ly + cy[..., None]
    poly = np.stack([px, py], axis=-1).reshape(*r.shape[:-1], 8)
    return _best_begin_point(poly).astype(np.float32)


def rotated_box_to_bbox_np(rrects):
    """(cx, cy, w, h, theta) [N, 5] -> (enclosing hbbs [N, 4], quads [N,
    8]), f32: the hbb of ``rotated_box_to_poly_np``'s quad (le90)."""
    r = np.asarray(rrects, dtype=np.float32)
    if r.shape[0] == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0, 8), np.float32)
    polys = rotated_box_to_poly_np(r)
    xs, ys = polys[:, 0::2], polys[:, 1::2]
    hbb = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)],
                   axis=1).astype(np.float32)
    return hbb, polys
