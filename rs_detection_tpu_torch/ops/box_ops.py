"""Rotated-box algebra on torch tensors (the subset of
``rs_detection_tpu/ops/box_ops.py`` that the ported families use: the
two-stage heads, the dense single-stage heads, FCOS's ``distance2obb``,
``mintheta_obb`` and ``bbox2type``), and the numpy conversions of the
host-side data pipeline.

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


def mintheta_obb(obboxes):
    """The (w, h, theta) form of each box with the smaller |theta| (ties
    to the theta + pi/2 form, as in JAX)."""
    x, y, w, h, theta = obboxes.unbind(-1)
    t1 = regular_theta(theta)
    t2 = regular_theta(theta + HALF_PI)
    pick1 = torch.abs(t1) < torch.abs(t2)
    return torch.stack([x, y, torch.where(pick1, w, h),
                        torch.where(pick1, h, w),
                        torch.where(pick1, t1, t2)], dim=-1)


def distance2obb(points, distance):
    """FCOS decode: points [..., 2] and (left, top, right, bottom, theta)
    [..., 5] in the box's frame -> ``regular_obb`` boxes [..., 5]."""
    dist, theta = distance[..., :4], distance[..., 4]
    c, s = torch.cos(theta), torch.sin(theta)
    ox = (dist[..., 2] - dist[..., 0]) / 2
    oy = (dist[..., 3] - dist[..., 1]) / 2
    # the offset rotated by [[cos, sin], [-sin, cos]]
    cx = points[..., 0] + c * ox + s * oy
    cy = points[..., 1] - s * ox + c * oy
    return regular_obb(torch.stack(
        [cx, cy, dist[..., 0] + dist[..., 2], dist[..., 1] + dist[..., 3],
         theta], dim=-1))


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


def hbb2obb(hbboxes):
    """hbb -> obb with w >= h: a taller box turns by -pi/2."""
    x = (hbboxes[..., 0] + hbboxes[..., 2]) * 0.5
    y = (hbboxes[..., 1] + hbboxes[..., 3]) * 0.5
    w = hbboxes[..., 2] - hbboxes[..., 0]
    h = hbboxes[..., 3] - hbboxes[..., 1]
    wide = w >= h
    zeros = torch.zeros_like(x)
    return torch.stack([x, y, torch.where(wide, w, h),
                        torch.where(wide, h, w),
                        torch.where(wide, zeros, zeros - HALF_PI)], dim=-1)


def hbb2poly(hbboxes):
    """hbb -> its corners (l, t), (r, t), (r, b), (l, b)."""
    l, t, r, b = hbboxes.unbind(-1)
    return torch.stack([l, t, r, t, r, b, l, b], dim=-1)


def poly2hbb(polys):
    """poly [..., 2 K] -> the hbb (x0, y0, x1, y1) that bounds it."""
    pts = polys.reshape(*polys.shape[:-1], polys.shape[-1] // 2, 2)
    return torch.cat([pts.amin(dim=-2), pts.amax(dim=-2)], dim=-1)


def poly2obb(polys):
    """Quad [..., 8] -> ``regular_obb`` box: w the longer of the edges
    (p1, p2) / (p2, p3), theta along it (le90), the centre the midpoint of
    p1 and p3 (the JAX closed form, exact for rectangles)."""
    x1, y1, x2, y2, x3, y3, x4, y4 = polys[..., :8].unbind(-1)
    edge1 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    edge2 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    angle = norm_angle(torch.where(edge1 > edge2,
                                   torch.atan2(y2 - y1, x2 - x1),
                                   torch.atan2(y4 - y1, x4 - x1)), "le90")
    return regular_obb(torch.stack(
        [(x1 + x3) / 2.0, (y1 + y3) / 2.0, torch.maximum(edge1, edge2),
         torch.minimum(edge1, edge2), angle], dim=-1))


_BBOX_TYPES = {4: "hbb", 5: "obb", 8: "poly"}


def get_bbox_type(bboxes, with_score: bool = False) -> str:
    """"hbb", "obb", "poly" or "notype" by the last axis (less one with
    ``with_score``); tensors or numpy arrays."""
    return _BBOX_TYPES.get(bboxes.shape[-1] - (1 if with_score else 0),
                           "notype")


def get_bbox_dim(bbox_type: str, with_score: bool = False) -> int:
    """The last axis of a box type (plus one with ``with_score``)."""
    return {"hbb": 4, "obb": 5, "poly": 8}[bbox_type] + (
        1 if with_score else 0)


def bbox2type(bboxes, to_type: str):
    """Convert between "hbb" [..., 4], "obb" [..., 5] and "poly" [..., 8]
    (the JAX table)."""
    ori = get_bbox_type(bboxes)
    if ori == to_type:
        return bboxes
    table = {("poly", "obb"): poly2obb, ("poly", "hbb"): poly2hbb,
             ("obb", "poly"): obb2poly, ("obb", "hbb"): obb2hbb,
             ("hbb", "poly"): hbb2poly, ("hbb", "obb"): hbb2obb}
    return table[(ori, to_type)](bboxes)


def get_bbox_areas(bboxes):
    """Areas of hbbs [..., 4], obbs [..., 5] or quads [..., 8] (the
    shoelace formula, either winding)."""
    dim = bboxes.shape[-1]
    if dim == 4:
        return ((bboxes[..., 2] - bboxes[..., 0])
                * (bboxes[..., 3] - bboxes[..., 1]))
    if dim == 5:
        return bboxes[..., 2] * bboxes[..., 3]
    pts = bboxes.reshape(*bboxes.shape[:-1], 4, 2)
    rolled = torch.roll(pts, 1, dims=-2)
    cross = (pts[..., 0] * rolled[..., 1]
             - rolled[..., 0] * pts[..., 1]).sum(-1)
    return 0.5 * torch.abs(cross)


def poly_to_rotated_box(polys, angle_version: str = "le135"):
    """Quadrilaterals [..., 8+] -> (cx, cy, w, h, theta) [..., 5] on
    tensors (the JAX function; ``poly_to_rotated_box_np`` is its numpy
    form): w the longer of edges (p1, p2) / (p2, p3), theta along it
    (p1 -> p2, else p1 -> p4) normalized by ``angle_version``, the centre
    the midpoint of p1 and p3."""
    x1, y1, x2, y2, x3, y3, x4, y4 = polys[..., :8].unbind(-1)
    edge1 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    edge2 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    angle = norm_angle(torch.where(edge1 > edge2,
                                   torch.atan2(y2 - y1, x2 - x1),
                                   torch.atan2(y4 - y1, x4 - x1)),
                       angle_version)
    return torch.stack([(x1 + x3) / 2.0, (y1 + y3) / 2.0,
                        torch.maximum(edge1, edge2),
                        torch.minimum(edge1, edge2), angle], dim=-1)


def get_best_begin_point(polys):
    """Each quad's vertices in the cyclic order nearest (summed distance)
    to its hbb's TL-TR-BR-BL corners; columns after the 8th (a score)
    kept. Tensors or numpy arrays."""
    if not isinstance(polys, torch.Tensor):
        out = _best_begin_point(polys[..., :8])
        return np.concatenate([out, polys[..., 8:]], axis=-1) \
            if polys.shape[-1] > 8 else out
    pts = polys[..., :8].reshape(*polys.shape[:-1], 4, 2)
    lo, hi = pts.amin(-2), pts.amax(-2)
    corners = torch.stack([lo, torch.stack([hi[..., 0], lo[..., 1]], -1), hi,
                           torch.stack([lo[..., 0], hi[..., 1]], -1)], -2)
    rots = torch.stack([torch.roll(pts, -k, dims=-2) for k in range(4)], -3)
    dists = torch.sqrt(((rots - corners[..., None, :, :]) ** 2).sum(-1)) \
        .sum(-1)
    best = torch.argmin(dists, dim=-1)
    out = torch.take_along_dim(rots, best[..., None, None, None], dim=-3) \
        .reshape(*polys.shape[:-1], 8)
    return torch.cat([out, polys[..., 8:]], -1) if polys.shape[-1] > 8 \
        else out


def rotated_box_to_bbox(rrects):
    """obbs [..., 5] -> their enclosing hbbs [..., 4] on tensors, through
    ``rotated_box_to_poly`` (the JAX function;
    ``rotated_box_to_bbox_np`` is the numpy form, which also returns the
    quads)."""
    poly = rotated_box_to_poly(rrects)
    xs, ys = poly[..., 0::2], poly[..., 1::2]
    return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)],
                       dim=-1)


def rotated_box_to_poly(rrects):
    """(cx, cy, w, h, theta) -> quadrilateral in the JDet convention: the
    corners (-w/2, -h/2), (w/2, -h/2), (w/2, h/2), (-w/2, h/2) rotated by
    R = [[cos, -sin], [sin, cos]], in that order (the JAX function with
    ``best_begin=False``, which is how the cascade head calls it)."""
    cx, cy, w, h, theta = rrects.unbind(-1)
    c, s = torch.cos(theta), torch.sin(theta)
    dx, dy = w / 2.0, h / 2.0
    lx = torch.stack([-dx, dx, dx, -dx], dim=-1)
    ly = torch.stack([-dy, -dy, dy, dy], dim=-1)
    px = c[..., None] * lx - s[..., None] * ly + cx[..., None]
    py = s[..., None] * lx + c[..., None] * ly + cy[..., None]
    return torch.stack([px, py], dim=-1).reshape(*rrects.shape[:-1], 8)


def _safe_log(x):
    return torch.log(torch.clamp(x, min=1e-6))


def _stats(deltas, means, stds, dim: int):
    """means / stds tiled over the K boxes of [..., dim * K] deltas."""
    k = deltas.shape[-1] // dim
    kw = dict(dtype=deltas.dtype, device=deltas.device)
    return (torch.tensor(means, **kw).repeat(k),
            torch.tensor(stds, **kw).repeat(k))


def bbox2delta(proposals, gt, means=None, stds=None):
    """hbb encode with the legacy +1 on widths and heights."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          _safe_log(gw / pw), _safe_log(gh / ph)], dim=-1)
    if means is not None and stds is not None:
        m, s = _stats(deltas, means, stds, 4)
        deltas = (deltas - m) / s
    return deltas


def delta2bbox(rois, deltas, means=None, stds=None, max_shape=None,
               wh_ratio_clip: float = 16 / 1000):
    """hbb decode; ``deltas`` [..., 4 * K] against rois [..., 4]; dw / dh
    clipped to |log(wh_ratio_clip)|, corners to ``max_shape`` (h, w)
    when given."""
    if means is not None and stds is not None:
        m, s = _stats(deltas, means, stds, 4)
        deltas = deltas * s + m
    dx, dy = deltas[..., 0::4], deltas[..., 1::4]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = torch.clamp(deltas[..., 2::4], -max_ratio, max_ratio)
    dh = torch.clamp(deltas[..., 3::4], -max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1, y1 = gx - gw * 0.5, gy - gh * 0.5
    x2, y2 = gx + gw * 0.5, gy + gh * 0.5
    if max_shape is not None:
        x1 = torch.clamp(x1, 0, max_shape[1] - 1)
        y1 = torch.clamp(y1, 0, max_shape[0] - 1)
        x2 = torch.clamp(x2, 0, max_shape[1] - 1)
        y2 = torch.clamp(y2, 0, max_shape[0] - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


def bbox2delta_rotated(proposals, gt, means=(0.0,) * 5, stds=(1.0,) * 5):
    """obb encode in the proposal's rotated frame; the angle offset
    normalized to [-pi/4, 3pi/4) and over pi."""
    pw, ph, pa = proposals[..., 2], proposals[..., 3], proposals[..., 4]
    gw, gh, ga = gt[..., 2], gt[..., 3], gt[..., 4]
    cosa, sina = torch.cos(pa), torch.sin(pa)
    ox = gt[..., 0] - proposals[..., 0]
    oy = gt[..., 1] - proposals[..., 1]
    deltas = torch.stack([(cosa * ox + sina * oy) / pw,
                          (-sina * ox + cosa * oy) / ph,
                          _safe_log(gw / pw), _safe_log(gh / ph),
                          norm_angle(ga - pa) / PI], dim=-1)
    m, s = _stats(deltas, means, stds, 5)
    return (deltas - m) / s


def delta2bbox_rotated(rois, deltas, means=(0.0,) * 5, stds=(1.0,) * 5,
                       wh_ratio_clip: float = 16 / 1000):
    """obb decode; ``deltas`` [..., 5 * K] against rois [..., 5]. The JAX
    function takes ``max_shape`` and ignores it: no clipping here."""
    m, s = _stats(deltas, means, stds, 5)
    d = deltas * s + m
    dx, dy = d[..., 0::5], d[..., 1::5]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = torch.clamp(d[..., 2::5], -max_ratio, max_ratio)
    dh = torch.clamp(d[..., 3::5], -max_ratio, max_ratio)
    rx, ry, rw, rh, ra = (rois[..., i][..., None] for i in range(5))
    gx = dx * rw * torch.cos(ra) - dy * rh * torch.sin(ra) + rx
    gy = dx * rw * torch.sin(ra) + dy * rh * torch.cos(ra) + ry
    gw = rw * torch.exp(dw)
    gh = rh * torch.exp(dh)
    ga = norm_angle(PI * d[..., 4::5] + ra)
    return torch.stack([gx, gy, gw, gh, ga], dim=-1).reshape(deltas.shape)


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
    """Normalize angles: le90 -> [-pi/2, pi/2); le135 -> [-pi/4, 3pi/4)
    (numpy arrays or torch tensors: ``%`` is the floored modulo in
    both)."""
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


# ---------------------------------------------------------------------------
# roi packing, tensors or numpy arrays
# ---------------------------------------------------------------------------

def arb2roi(bbox_list, bbox_dim: int = 5):
    """Per-image boxes [N_i, bbox_dim+] -> rois [sum N_i, 1 + bbox_dim]
    with the image index in front, in the boxes' dtype."""
    if bbox_list and isinstance(bbox_list[0], torch.Tensor):
        return torch.cat([torch.cat([torch.full(
            (b.shape[0], 1), float(i), dtype=b.dtype, device=b.device),
            b[:, :bbox_dim]], -1) for i, b in enumerate(bbox_list)], 0)
    return np.concatenate([np.concatenate([np.full(
        (b.shape[0], 1), float(i), dtype=b.dtype), b[:, :bbox_dim]], -1)
        for i, b in enumerate(bbox_list)], 0)


def bbox2roi(bbox_list):
    """``arb2roi`` of hbbs: rois [sum N_i, 5]."""
    return arb2roi(bbox_list, 4)
