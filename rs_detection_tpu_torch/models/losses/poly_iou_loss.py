"""Gaussian-distribution box losses (counterpart of the GWD / KLD /
KFIoU part of ``rs_detection_tpu/models/losses/poly_iou_loss.py``): each
(cx, cy, w, h, theta) box becomes a 2-D Gaussian, and the 2 x 2 algebra
is written out in closed form, as in the JAX module. ``kfiou_loss`` is
the stage-2 loss of the KFIoU RoI-Transformer configs; ``gwd_loss``,
``kld_loss`` and ``GDLoss`` are ported as functions that no config
reaches (the JAX ``adapt_cascade_head`` maps only KFIoU, so the GWD and
KLD configs train smooth L1 there and here). Each weights its
per-box loss and averages it (over ``avg_factor`` when given); the JAX
``reduction="none"/"sum"`` is not ported, as in ``common.py``: no
caller uses it. The polygon-IoU losses
(``PolyIoULoss``, ``PolyGIoULoss``) wait for their families (ROADMAP.md,
Queue 1, item 11)."""

from __future__ import annotations

import torch

from ...utils.registry import LOSSES
from .common import weight_reduce_loss


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
        if reduction != "mean":
            raise NotImplementedError(f"GDLoss: reduction {reduction!r}; "
                                      f"only the mean is ported")
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
