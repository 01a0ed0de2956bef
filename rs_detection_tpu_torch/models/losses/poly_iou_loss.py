"""Differentiable polygon-IoU and Gaussian-distribution box losses
(counterpart of ``rs_detection_tpu/models/losses/poly_iou_loss.py``).

The polygon half (``poly_iou_loss``, ``poly_giou_loss`` and their
registered forms ``PolyIoULoss``, ``PolyGIoULoss``) is FCOS's regression
loss: each aligned pair of boxes becomes two quads, the candidate points
of their overlap (the 16 edge crossings and the 8 vertices, each with a
validity mask) are ordered about their centroid by ``ops/convex_sort``,
and the shoelace formula gives the overlap. The gradient flows through
the points' coordinates; the masks are comparisons and carry none, as
the JAX function stops their gradient. The crossing parameter divides by
``num + eps`` while its mask divides by ``num`` kept away from 0 by
``eps``, and a vertex is inside when the four triangle-fan areas sum to
the other quad's area within a relative 1e-3, all as in JAX.

The Gaussian half: each (cx, cy, w, h, theta) box becomes a 2-D
Gaussian, and the 2 x 2 algebra is written out in closed form, as in the
JAX module. ``kfiou_loss`` is the stage-2 loss of the KFIoU
RoI-Transformer configs; ``gwd_loss``, ``kld_loss`` and ``GDLoss`` are
ported as functions that no config reaches (the JAX
``adapt_cascade_head`` maps only KFIoU, so the GWD and KLD configs train
smooth L1 there and here).

Each loss weights its per-box loss and averages it (over ``avg_factor``
when given); the JAX ``reduction="none"/"sum"`` is not ported, as in
``common.py``: no caller uses it."""

from __future__ import annotations

import torch

from ...ops.box_ops import bbox2type, get_bbox_areas
from ...ops.convex_sort import convex_sort
from ...utils.registry import LOSSES
from .common import require_mean, weight_reduce_loss


def shoelace(pts):
    """Area of the polygons [..., N, 2] in their vertex order."""
    rolled = torch.roll(pts, 1, dims=-2)
    x = pts[..., 0] * rolled[..., 1] - rolled[..., 0] * pts[..., 1]
    return 0.5 * torch.abs(x.sum(-1))


def convex_areas(pts, masks):
    """Area of each masked point set [B, N, 2] taken in its angular order
    about the centroid (``convex_sort``; invalid slots read as a zero
    point)."""
    b, n, _ = pts.shape
    index = convex_sort(pts, masks)                    # [B, N + 1]
    index = torch.where(index == -1, n, index)
    ext = torch.cat([pts, pts.new_zeros(b, 1, 2)], dim=1)
    polys = torch.gather(ext, 1, index[..., None].expand(-1, -1, 2))
    x1 = polys[:, :-1, 0] * polys[:, 1:, 1]
    x2 = polys[:, :-1, 1] * polys[:, 1:, 0]
    return 0.5 * torch.abs((x1 - x2).sum(-1))


def poly_intersection(pts1, pts2, areas1=None, areas2=None, eps=1e-6):
    """The overlap's candidate points of aligned quad pairs [B, 4, 2] and
    their masks: [B, 24, 2] and [B, 24] (the 16 edge crossings, then
    quad 1's vertices inside quad 2, then quad 2's inside quad 1)."""
    l1 = torch.cat([pts1, torch.roll(pts1, -1, dims=1)], dim=2)[:, :, None]
    l2 = torch.cat([pts2, torch.roll(pts2, -1, dims=1)], dim=2)[:, None]
    x1, y1, x2, y2 = l1.unbind(-1)                      # [B, 4, 1]
    x3, y3, x4, y4 = l2.unbind(-1)                      # [B, 1, 4]

    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    den_t = (x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)
    den_u = (x2 - x1) * (y1 - y3) - (y2 - y1) * (x1 - x3)
    safe_num = torch.where(num.abs() < eps, eps, num)
    t_m = den_t / safe_num
    u_m = den_u / safe_num
    mask_inter = (t_m > 0) & (t_m < 1) & (u_m > 0) & (u_m < 1)

    t = den_t / (num + eps)
    b = pts1.shape[0]
    pts_inter = torch.stack([x1 + t * (x2 - x1), y1 + t * (y2 - y1)],
                            dim=-1).reshape(b, -1, 2)
    if areas1 is None:
        areas1 = shoelace(pts1)
    if areas2 is None:
        areas2 = shoelace(pts2)
    # a vertex is inside when its triangle fan covers the other quad
    tri1 = 0.5 * torch.abs((x3 - x1) * (y4 - y1) - (y3 - y1) * (x4 - x1))
    inside1 = (tri1.sum(-1) - areas2[..., None]).abs() \
        < 1e-3 * areas2[..., None]
    tri2 = 0.5 * torch.abs((x1 - x3) * (y2 - y3) - (x2 - x3) * (y1 - y3))
    inside2 = (tri2.sum(-2) - areas1[..., None]).abs() \
        < 1e-3 * areas1[..., None]
    all_pts = torch.cat([pts_inter, pts1, pts2], dim=1)
    masks = torch.cat([mask_inter.reshape(b, -1), inside1, inside2], dim=1)
    return all_pts, masks


def _quads(pred, target, eps):
    """Both boxes' areas, quads [B, 4, 2], and their overlap."""
    areas1 = get_bbox_areas(pred)
    areas2 = get_bbox_areas(target)
    p = bbox2type(pred, "poly").reshape(pred.shape[0], -1, 2)
    t = bbox2type(target, "poly").reshape(target.shape[0], -1, 2)
    pts, masks = poly_intersection(p, t, areas1, areas2, eps)
    return areas1, areas2, p, t, convex_areas(pts, masks)


def poly_iou_loss(pred, target, linear: bool = False, eps: float = 1e-6,
                  weight=None, avg_factor=None):
    """-log IoU (``linear``: 1 - IoU) of aligned boxes [B, 5] (or hbbs,
    quads), the IoU clipped below at ``eps``."""
    areas1, areas2, _, _, overlap = _quads(pred, target, eps)
    ious = torch.clamp(overlap / (areas1 + areas2 - overlap + eps), min=eps)
    loss = (1 - ious) if linear else -torch.log(ious)
    return weight_reduce_loss(loss, weight, avg_factor)


def poly_giou_loss(pred, target, eps: float = 1e-6, weight=None,
                   avg_factor=None):
    """1 - GIoU of aligned boxes, the enclosing area that of all eight
    vertices in their angular order (as in JAX)."""
    areas1, areas2, p, t, overlap = _quads(pred, target, eps)
    union = areas1 + areas2 - overlap + eps
    ious = torch.clamp(overlap / union, min=eps)
    enc_pts = torch.cat([p, t], dim=1)
    enclose = convex_areas(enc_pts, torch.ones(
        enc_pts.shape[:2], dtype=torch.bool, device=enc_pts.device))
    gious = ious - (enclose - union) / torch.clamp(enclose, min=eps)
    return weight_reduce_loss(1 - gious, weight, avg_factor)


@LOSSES.register_module()
class PolyIoULoss:
    """The config form of ``poly_iou_loss``; a weight [N, k] is averaged
    over its last axis."""

    def __init__(self, linear=False, eps=1e-6, reduction="mean",
                 loss_weight=1.0):
        require_mean("PolyIoULoss", reduction)
        self.linear = linear
        self.eps = eps
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if weight is not None and weight.ndim > 1:
            weight = weight.mean(-1)
        return self.loss_weight * poly_iou_loss(
            pred, target, self.linear, self.eps, weight, avg_factor)


@LOSSES.register_module()
class PolyGIoULoss:
    """The config form of ``poly_giou_loss``."""

    def __init__(self, eps=1e-6, reduction="mean", loss_weight=1.0):
        require_mean("PolyGIoULoss", reduction)
        self.eps = eps
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if weight is not None and weight.ndim > 1:
            weight = weight.mean(-1)
        return self.loss_weight * poly_giou_loss(
            pred, target, self.eps, weight, avg_factor)


def xy_wh_r_2_xy_sigma(xywhr):
    """obb -> (centre [..., 2], covariance [..., 2, 2]):
    R diag((w/2)^2, (h/2)^2) R^T with w, h clipped to [1e-7, 1e7]."""
    xy = xywhr[..., :2]
    wh = torch.clamp(xywhr[..., 2:4], 1e-7, 1e7)
    c, s = torch.cos(xywhr[..., 4]), torch.sin(xywhr[..., 4])
    a = (0.5 * wh[..., 0]) ** 2
    b = (0.5 * wh[..., 1]) ** 2
    s11 = a * c * c + b * s * s
    s12 = (a - b) * s * c
    s22 = a * s * s + b * c * c
    sigma = torch.stack([torch.stack([s11, s12], -1),
                         torch.stack([s12, s22], -1)], -2)
    return xy, sigma


def _det2(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def _inv2(m, eps: float = 1e-7):
    det = _det2(m)
    det = torch.where(det.abs() < eps, eps, det)
    inv = torch.stack([torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
                       torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1)], -2)
    return inv / det[..., None, None]


def _trace2(m):
    return m[..., 0, 0] + m[..., 1, 1]


def gwd_loss(pred, target, fun: str = "sqrt", tau: float = 2.0, weight=None,
             avg_factor=None):
    """Gaussian Wasserstein distance loss of decoded boxes."""
    xy_p, sp = xy_wh_r_2_xy_sigma(pred)
    xy_t, st = xy_wh_r_2_xy_sigma(target)
    xy_dist = ((xy_p - xy_t) ** 2).sum(-1)
    det_sqrt = torch.sqrt(torch.clamp(_det2(sp) * _det2(st), min=0))
    whr = _trace2(sp) + _trace2(st) - 2 * torch.sqrt(torch.clamp(
        _trace2(sp @ st) + 2 * det_sqrt, min=0))
    dis = torch.clamp(xy_dist + whr, min=1e-6)
    if fun == "sqrt":
        loss = 1 - 1 / (tau + torch.sqrt(dis))
    elif fun == "log1p":
        loss = 1 - 1 / (tau + torch.log1p(dis))
    else:
        scale = torch.clamp(2 * torch.sqrt(torch.sqrt(det_sqrt)), min=1e-7)
        loss = torch.log1p(torch.sqrt(dis) / scale)
    return weight_reduce_loss(loss, weight, avg_factor)


def kld_loss(pred, target, fun: str = "log1p", tau: float = 1.0, weight=None,
             avg_factor=None):
    """Kullback-Leibler divergence loss of decoded boxes."""
    xy_p, sp = xy_wh_r_2_xy_sigma(pred)
    xy_t, st = xy_wh_r_2_xy_sigma(target)
    delta = xy_p - xy_t
    st_inv = _inv2(st)
    term1 = torch.einsum("...i,...ij,...j->...", delta, st_inv, delta)
    term2 = _trace2(st_inv @ sp) + torch.log(torch.clamp(
        _det2(st) / torch.clamp(_det2(sp), min=1e-7), min=1e-7))
    dis = torch.clamp(term1 + term2 - 2, min=1e-6)
    if fun == "sqrt":
        loss = 1 - 1 / (tau + torch.sqrt(dis))
    else:
        loss = 1 - 1 / (tau + torch.log1p(dis))
    return weight_reduce_loss(loss, weight, avg_factor)


def kfiou_loss(pred, target, pred_decode=None, targets_decode=None, fun=None,
               beta: float = 1.0 / 9.0, eps: float = 1e-6, weight=None,
               avg_factor=None):
    """Kalman-filter IoU loss: smooth L1 of the centre deltas plus a term
    of the overlap of the decoded boxes' Gaussians (``fun`` "ln", "exp",
    else 1 - KFIoU). Degenerate boxes make the covariance singular and
    the loss NaN: mask them before the call, never after (NaN x 0 is
    NaN, in backward too)."""
    diff = (pred[..., :2] - target[..., :2]).abs()
    xy_loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                          diff - 0.5 * beta).sum(-1)
    _, sp = xy_wh_r_2_xy_sigma(pred_decode)
    _, st = xy_wh_r_2_xy_sigma(targets_decode)
    vb_p = 4 * torch.sqrt(torch.clamp(_det2(sp), min=0))
    vb_t = 4 * torch.sqrt(torch.clamp(_det2(st), min=0))
    k = sp @ _inv2(sp + st)
    vb = 4 * torch.sqrt(torch.clamp(_det2(sp - k @ sp), min=0))
    kfiou = vb / (vb_p + vb_t - vb + eps)
    if fun == "ln":
        kf = -torch.log(kfiou + eps)
    elif fun == "exp":
        kf = torch.exp(1 - kfiou) - 1
    else:
        kf = 1 - kfiou
    loss = torch.clamp(xy_loss + kf, min=0)
    return weight_reduce_loss(loss, weight, avg_factor)


@LOSSES.register_module()
class GDLoss:
    """Dispatcher over ``gwd``, ``kld`` and ``kfiou`` by ``loss_type``."""

    BAG = {"gwd": gwd_loss, "kld": kld_loss, "kfiou": kfiou_loss}

    def __init__(self, loss_type, fun: str = "log1p", tau: float = 1.0,
                 reduction: str = "mean", loss_weight: float = 1.0, **kwargs):
        if loss_type not in self.BAG:
            raise ValueError(f"GDLoss: loss_type {loss_type!r}, not one of "
                             f"{sorted(self.BAG)}")
        require_mean("GDLoss", reduction)
        self.loss_type = loss_type
        self.fun = fun
        self.tau = tau
        self.loss_weight = loss_weight
        self.kwargs = kwargs

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 pred_decode=None, targets_decode=None, **_):
        if weight is not None and weight.ndim > 1:
            weight = weight.mean(-1)
        fn = self.BAG[self.loss_type]
        if self.loss_type == "kfiou":
            loss = fn(pred, target, pred_decode=pred_decode,
                      targets_decode=targets_decode, fun=self.fun,
                      weight=weight, avg_factor=avg_factor, **self.kwargs)
        else:
            loss = fn(pred, target, fun=self.fun, tau=self.tau,
                      weight=weight, avg_factor=avg_factor)
        return self.loss_weight * loss
