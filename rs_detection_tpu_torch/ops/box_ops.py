"""Rotated-box algebra on torch tensors (the subset of
``rs_detection_tpu/ops/box_ops.py`` that Oriented R-CNN inference uses).

obb = (cx, cy, w, h, theta), theta in radians, OBBDetection convention
(``obb2poly`` rotates by R = [[cos, sin], [-sin, cos]]); hbb = (x0, y0,
x1, y1); poly = (x0, y0, ..., x3, y3).
"""

from __future__ import annotations

import math

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
