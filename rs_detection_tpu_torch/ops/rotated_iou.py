"""Exact rotated-box IoU (counterpart of
``rs_detection_tpu/ops/rotated_iou.py:box_iou_rotated``), plain PyTorch.

IoU of (cx, cy, w, h, theta) boxes by vertex enumeration: the 16 edge
intersections and the 8 corners inside the other box give up to 24
candidate points, sorted by angle around their centroid, then a shoelace
fan gives the intersection area. The tolerances and the corner order
are the JAX package's, so both sides pick the same points. Batched over
leading dimensions. Used by the assigners and NMS on detached boxes, so
it carries no gradient.

The pair matrix is computed in flattened blocks of at most
``PAIR_BLOCK`` pairs, as the JAX function is (its ``_PAIR_BLOCK``): the
intermediates take about 2.5 KB a pair (24 candidates, their masks,
sort keys, int64 sort indices and gathered copies), so a block of 2^21
pairs holds about 5 GiB at its peak, where the whole [B, A, G] matrix of
an S2ANet assignment (89 M pairs at batch 2, 1024^2, 512 slots) would
not fit on an 80 GB card. The budget is the card's: 8x the JAX one,
which would cut such a matrix into 341 blocks of a few hundred launches
each. Every value is the same in any blocking, bit for bit, on the CPU
as on the card: the corners (the only sines and cosines) are computed
once a box, the candidates' order comes from a pseudo-angle made of
exact IEEE operations (a monotone map of ``atan2``, whose vectorized
and scalar CPU forms differ in the last bit), and the sums over the 24
candidates add in a fixed order.
"""

from __future__ import annotations

import torch

_EPS_DENOM = 1e-14
_EPS_AREA = 1e-14


def _corners(boxes):
    """[..., 5] obb -> corner x, y, each [4, ...] (the JAX corner order)."""
    cx, cy, w, h, t = boxes.unbind(-1)
    c, s = torch.cos(t), torch.sin(t)
    dx, dy = w * 0.5, h * 0.5
    xs, ys = [], []
    for sx, sy in ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)):
        lx, ly = sx * dx, sy * dy
        xs.append(c * lx - s * ly + cx)
        ys.append(s * lx + c * ly + cy)
    return torch.stack(xs), torch.stack(ys)


def _inside(ptx, pty, qx, qy):
    """Points inside the convex quad with corners (qx, qy) [4, ...]."""
    pos = neg = None
    for j in range(4):
        ax, ay = qx[j], qy[j]
        bx, by = qx[(j + 1) % 4], qy[(j + 1) % 4]
        cr = (bx - ax) * (pty - ay) - (by - ay) * (ptx - ax)
        p, q = cr >= -1e-8, cr <= 1e-8
        pos = p if pos is None else pos & p
        neg = q if neg is None else neg & q
    orient = ((qx[1] - qx[0]) * (qy[2] - qy[0])
              - (qy[1] - qy[0]) * (qx[2] - qx[0]))
    return torch.where(orient >= 0, pos, neg)


def _pseudo_angle(vx, vy):
    """A strictly increasing function of ``atan2(vy, vx)`` on (-pi, pi],
    in (-2, 2], from +, -, / and compares only: ``vy / (|vx| + |vy|)``
    on the right half plane, 2 minus it above the left one, -2 minus it
    below."""
    d = vx.abs() + vy.abs()
    r = vy / torch.where(d > 0, d, 1.0)
    return torch.where(vx >= 0, r, torch.where(vy >= 0, 2.0 - r, -2.0 - r))


def _ordered_sum(rows):
    """The sum over the leading axis of ``rows`` in an order fixed by
    that axis alone: halves added elementwise while the length is even
    (24 -> 12 -> 6 -> 3), then the rest in row order. A reduction
    kernel's order may change with the other axes' size on the card."""
    while rows.shape[0] % 2 == 0:
        half = rows.shape[0] // 2
        rows = rows[:half] + rows[half:]
    out = rows[0]
    for r in rows[1:]:
        out = out + r
    return out


def _inter_area(x1, y1, x2, y2):
    """Intersection area of two convex quads, corners [4, ...] -> [...]."""
    px, py, pm = [], [], []
    for i in range(4):
        p1x, p1y = x1[i], y1[i]
        d1x, d1y = x1[(i + 1) % 4] - p1x, y1[(i + 1) % 4] - p1y
        for j in range(4):
            q1x, q1y = x2[j], y2[j]
            d2x, d2y = x2[(j + 1) % 4] - q1x, y2[(j + 1) % 4] - q1y
            denom = d1x * d2y - d1y * d2x
            safe = denom.abs() > _EPS_DENOM
            dn = torch.where(safe, denom, 1.0)
            rx, ry = q1x - p1x, q1y - p1y
            t = (rx * d2y - ry * d2x) / dn
            s = (rx * d1y - ry * d1x) / dn
            # the JAX tolerance on the unit window: coincident edges put
            # their intersections exactly at segment ends, where rounding
            # can step an ulp outside; the point is clamped onto the edge
            tol = 1e-5
            hit = safe & (t >= -tol) & (t <= 1.0 + tol) \
                & (s >= -tol) & (s <= 1.0 + tol)
            tc = t.clamp(0.0, 1.0)
            px.append(p1x + tc * d1x)
            py.append(p1y + tc * d1y)
            pm.append(hit)
    for i in range(4):
        px.append(x1[i])
        py.append(y1[i])
        pm.append(_inside(x1[i], y1[i], x2, y2))
    for i in range(4):
        px.append(x2[i])
        py.append(y2[i])
        pm.append(_inside(x2[i], y2[i], x1, y1))
    ptx, pty, m = torch.stack(px), torch.stack(py), torch.stack(pm)
    k = m.sum(0)
    mf = m.to(ptx.dtype)
    inv = 1.0 / k.clamp(min=1)
    vx = ptx - _ordered_sum(ptx * mf) * inv
    vy = pty - _ordered_sum(pty * mf) * inv
    ang = torch.where(m, _pseudo_angle(vx, vy), 1e9)    # invalid last
    order = torch.sort(ang, dim=0, stable=True).indices
    vx = vx.gather(0, order)
    vy = vy.gather(0, order)
    ms = m.gather(0, order)
    # triangle fan over consecutive valid points, closed by (k-1, 0)
    # unless all 24 are valid (then the roll's wraparound closes it)
    vnx, vny = vx.roll(-1, 0), vy.roll(-1, 0)
    mn = ms.roll(-1, 0)
    fan = _ordered_sum((vx * vny - vy * vnx) * (ms & mn))
    last = (k - 1).clamp(0, 23)
    vlx = vx.gather(0, last[None]).squeeze(0)
    vly = vy.gather(0, last[None]).squeeze(0)
    fan = fan + torch.where(k < 24, vlx * vy[0] - vly * vx[0], 0.0)
    return torch.where(k >= 3, 0.5 * fan.abs(), 0.0)


# pairs a block (see the module docstring)
PAIR_BLOCK = 1 << 21


def _iou_of_pairs(x1, y1, x2, y2, area1, area2, mode: str):
    """IoU of aligned pairs from their corners ([4, ...] each) and
    areas."""
    inter = _inter_area(x1, y1, x2, y2)
    if mode == "iou":
        denom = area1 + area2 - inter
        valid = (area1 > _EPS_AREA) & (area2 > _EPS_AREA)
    else:
        denom = area1
        valid = area1 > _EPS_AREA
    iou = inter / denom.clamp(min=_EPS_AREA)
    return torch.where(valid, iou.clamp(0.0, 1.0), 0.0)


def box_iou_rotated(boxes1, boxes2, mode: str = "iou",
                    pair_block: int = PAIR_BLOCK):
    """Pairwise exact rotated IoU: [..., N, 5] x [..., M, 5] -> [..., N, M]
    f32 (``mode="iof"``: intersection over the area of ``boxes1``), in
    blocks of rows of ``boxes1`` that hold at most ``pair_block`` pairs
    (at least one row)."""
    if mode not in ("iou", "iof"):
        raise ValueError(f"box_iou_rotated: mode {mode!r}")
    b1, b2 = boxes1.float(), boxes2.float()
    batch = torch.broadcast_shapes(b1.shape[:-2], b2.shape[:-2])
    n, m = b1.shape[-2], b2.shape[-2]
    b1 = b1.expand(*batch, n, 5)
    b2 = b2.expand(*batch, m, 5)
    out = b1.new_zeros(*batch, n, m)
    if out.numel() == 0:
        return out
    x1, y1 = _corners(b1)                          # [4, ..., N]
    x2, y2 = _corners(b2)                          # [4, ..., M]
    area1 = (b1[..., 2] * b1[..., 3])[..., :, None]
    area2 = (b2[..., 2] * b2[..., 3])[..., None, :]
    rows = max(1, pair_block // (out.numel() // n))
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        xa, xb = torch.broadcast_tensors(x1[..., sl, None], x2[..., None, :])
        ya, yb = torch.broadcast_tensors(y1[..., sl, None], y2[..., None, :])
        out[..., sl, :] = _iou_of_pairs(xa, ya, xb, yb, area1[..., sl, :],
                                        area2, mode)
    return out


def box_iou_rotated_v1(boxes1, boxes2, mode: str = "iou", **kw):
    """The mmrotate / OBBDetection entry point: ``box_iou_rotated`` (the
    IoU values of the two conventions coincide)."""
    return box_iou_rotated(boxes1, boxes2, mode=mode, **kw)


def _shoelace(xs, ys):
    s = None
    for i in range(4):
        t = xs[i] * ys[(i + 1) % 4] - xs[(i + 1) % 4] * ys[i]
        s = t if s is None else s + t
    return 0.5 * s.abs()


def poly_iou(polys1, polys2, mode: str = "iou",
             pair_block: int = PAIR_BLOCK):
    """Pairwise exact IoU of convex quadrilaterals: [N, 8] x [M, 8] ->
    [N, M] f32 (``mode="iof"``: over the area of ``polys1``), on the
    candidate-point core of ``box_iou_rotated`` with the quads' own
    corners and their shoelace areas, in blocks of at most
    ``pair_block`` pairs. A non-convex quad is taken as its vertex hull
    would be by that core, as in JAX."""
    if mode not in ("iou", "iof"):
        raise ValueError(f"poly_iou: mode {mode!r}")
    n, m = polys1.shape[0], polys2.shape[0]
    out = polys1.new_zeros(n, m, dtype=torch.float32)
    if n == 0 or m == 0:
        return out
    c1 = polys1.float().reshape(n, 4, 2).permute(1, 2, 0)   # [4, 2, N]
    c2 = polys2.float().reshape(m, 4, 2).permute(1, 2, 0)
    area1 = _shoelace(c1[:, 0], c1[:, 1])[:, None]
    area2 = _shoelace(c2[:, 0], c2[:, 1])[None, :]
    rows = max(1, pair_block // m)
    for r0 in range(0, n, rows):
        sl = slice(r0, r0 + rows)
        xa, xb = torch.broadcast_tensors(c1[:, 0, sl, None], c2[:, 0, None])
        ya, yb = torch.broadcast_tensors(c1[:, 1, sl, None], c2[:, 1, None])
        inter = _inter_area(xa, ya, xb, yb)
        a1 = area1[sl]
        denom = a1 + area2 - inter if mode == "iou" else a1.expand_as(inter)
        out[sl] = torch.where(
            denom > _EPS_AREA,
            (inter / denom.clamp(min=_EPS_AREA)).clamp(0.0, 1.0), 0.0)
    return out
