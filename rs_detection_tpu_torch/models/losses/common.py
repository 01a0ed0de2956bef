"""Detection losses with weight masks and an ``avg_factor`` (counterpart
of ``rs_detection_tpu/models/losses/common.py``): every loss takes dense
predictions and targets, a weight per element, and sums over
``max(avg_factor, 1)`` when one is given, else averages. The JAX
functions' ``reduction="none"/"sum"`` is not ported: no caller uses it."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weight_reduce_loss(loss, weight=None, avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    avg = torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device)
    return loss.sum() / avg.clamp(min=1.0)


def binary_cross_entropy(pred, label, weight=None, avg_factor=None):
    """Sigmoid BCE on logits."""
    loss = F.binary_cross_entropy_with_logits(pred, label, reduction="none")
    return weight_reduce_loss(loss, weight, avg_factor)


def smooth_l1_loss(pred, target, weight=None, beta: float = 1.0,
                   avg_factor=None):
    """0.5 d^2 / beta below beta, d - beta / 2 above."""
    loss = F.smooth_l1_loss(pred, target, reduction="none", beta=beta)
    return weight_reduce_loss(loss, weight, avg_factor)


def softmax_cross_entropy(pred, label, weight=None, avg_factor=None,
                          ignore_index: int = -1):
    """Softmax CE over integer labels; ``ignore_index`` rows count 0."""
    loss = F.cross_entropy(pred, label, reduction="none",
                           ignore_index=ignore_index)
    return weight_reduce_loss(loss, weight, avg_factor)
