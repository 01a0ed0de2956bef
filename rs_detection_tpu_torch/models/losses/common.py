"""Detection losses with weight masks and an ``avg_factor`` (counterpart
of ``rs_detection_tpu/models/losses/common.py``): every loss takes dense
predictions and targets, a weight per element, and with the default
``reduction="mean"`` sums over ``max(avg_factor, 1)`` when one is given,
else averages; "sum" sums and "none" gives the weighted elements, as the
JAX functions' ``reduction``. Under a process group an ``avg_factor`` is
a count over the global batch (``parallel/dist.py:divide_by_count``) and
a sum is scaled by the world size, so that the ranks' mean is the global
loss; a plain mean over equal shards needs nothing. ``FocalLoss``,
``SmoothL1Loss``, ``L1Loss``, ``CrossEntropyLoss`` (softmax, or sigmoid
with ``use_sigmoid`` / ``use_bce``), ``CrossEntropyLossForRcnn`` and
``BinaryCrossEntropyLoss`` are the registered config forms; the heads
call the functions."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...parallel import dist
from ...utils.registry import LOSSES


def weight_reduce_loss(loss, weight=None, avg_factor=None,
                       reduction="mean"):
    """``reduction`` "none", "sum", or anything else for the mean, as
    JAX reads it."""
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum() * dist.world()
    if avg_factor is None:
        return loss.mean()
    return dist.divide_by_count(loss.sum(), avg_factor)


def binary_cross_entropy(pred, label, weight=None, avg_factor=None,
                         reduction="mean"):
    """Sigmoid BCE on logits."""
    loss = F.binary_cross_entropy_with_logits(pred, label, reduction="none")
    return weight_reduce_loss(loss, weight, avg_factor, reduction)


def sigmoid_bce(logits, labels):
    """Elementwise BCE on logits in the JAX package's stable form,
    ``max(x, 0) - x * t + log1p(exp(-|x|))``."""
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(pred, target_onehot, weight=None, gamma: float = 2.0,
                       alpha: float = 0.25, avg_factor=None,
                       reduction="mean"):
    """Sigmoid focal loss (reference ``focal_loss.py:36-75``): pred [N, C]
    logits, target_onehot [N, C] in {0, 1} (a background row all zero),
    weight [N] or [N, C]."""
    p = torch.sigmoid(pred)
    ce = sigmoid_bce(pred, target_onehot)
    p_t = p * target_onehot + (1 - p) * (1 - target_onehot)
    alpha_t = alpha * target_onehot + (1 - alpha) * (1 - target_onehot)
    loss = alpha_t * ((1 - p_t) ** gamma) * ce
    if weight is not None and weight.dim() == 1:
        weight = weight[:, None]
    return weight_reduce_loss(loss, weight, avg_factor, reduction)


def smooth_l1_loss(pred, target, weight=None, beta: float = 1.0,
                   avg_factor=None, reduction="mean"):
    """0.5 d^2 / beta below beta, d - beta / 2 above."""
    loss = F.smooth_l1_loss(pred, target, reduction="none", beta=beta)
    return weight_reduce_loss(loss, weight, avg_factor, reduction)


def l1_loss(pred, target, weight=None, avg_factor=None, reduction="mean"):
    return weight_reduce_loss(torch.abs(pred - target), weight, avg_factor,
                              reduction)


def softmax_cross_entropy(pred, label, weight=None, avg_factor=None,
                          ignore_index: int = -1, reduction="mean"):
    """Softmax CE over integer labels; ``ignore_index`` rows count 0."""
    loss = F.cross_entropy(pred, label, reduction="none",
                           ignore_index=ignore_index)
    return weight_reduce_loss(loss, weight, avg_factor, reduction)


@LOSSES.register_module()
class FocalLoss:
    """The config form of ``sigmoid_focal_loss`` on integer labels (0 =
    background, k > 0 = channel k - 1). Sigmoid only: JAX asserts
    ``use_sigmoid``."""

    def __init__(self, use_sigmoid=True, gamma=2.0, alpha=0.25,
                 reduction="mean", loss_weight=1.0):
        if not use_sigmoid:
            raise NotImplementedError("FocalLoss: only use_sigmoid=True, "
                                      "as in the JAX package")
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        classes = torch.arange(1, pred.shape[-1] + 1, device=pred.device)
        onehot = (target[..., None] == classes).to(pred.dtype)
        return self.loss_weight * sigmoid_focal_loss(
            pred, onehot, weight, self.gamma, self.alpha, avg_factor,
            self.reduction)


@LOSSES.register_module()
class SmoothL1Loss:
    """The config form of ``smooth_l1_loss``."""

    def __init__(self, beta=1.0, reduction="mean", loss_weight=1.0):
        self.beta = beta
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * smooth_l1_loss(
            pred, target, weight, self.beta, avg_factor, self.reduction)


@LOSSES.register_module()
class L1Loss:
    """The config form of ``l1_loss``."""

    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * l1_loss(pred, target, weight, avg_factor,
                                          self.reduction)


@LOSSES.register_module()
class CrossEntropyLoss:
    """Softmax cross entropy over integer labels, or with ``use_sigmoid``
    (``use_bce``, the FCOS configs' centerness loss) the sigmoid BCE on
    logits."""

    def __init__(self, use_sigmoid=False, use_bce=False, reduction="mean",
                 loss_weight=1.0, ignore_index=-1):
        self.use_sigmoid = use_sigmoid or use_bce
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, weight=None, avg_factor=None):
        if self.use_sigmoid:
            loss = binary_cross_entropy(pred, target, weight, avg_factor,
                                        self.reduction)
        else:
            loss = softmax_cross_entropy(pred, target, weight, avg_factor,
                                         self.ignore_index, self.reduction)
        return self.loss_weight * loss


@LOSSES.register_module()
class CrossEntropyLossForRcnn(CrossEntropyLoss):
    """The RCNN variant (reference ``cross_entropy_loss.py:130``)."""


@LOSSES.register_module()
class BinaryCrossEntropyLoss:
    """The config form of ``binary_cross_entropy`` on logits."""

    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        return self.loss_weight * binary_cross_entropy(
            pred, target, weight, avg_factor, self.reduction)
