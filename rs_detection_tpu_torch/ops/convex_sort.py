"""Order masked point sets counter-clockwise about their centroid
(counterpart of ``rs_detection_tpu/ops/convex_sort.py``), for the
differentiable polygon-IoU losses (``models/losses/poly_iou_loss.py``).
One stable argsort by angle; invalid points sort last. Plain PyTorch on
every device: the JAX function is a plain argsort too."""

from __future__ import annotations

import torch


def convex_sort(pts, masks, circular: bool = True):
    """pts [B, N, 2], masks [B, N] -> indices [B, N (+1)] (int64) that
    order each set's valid points by ``atan2`` about their masked
    centroid, ties of angle in index order; invalid slots are -1. With
    ``circular`` the first valid index is repeated directly after the last
    valid one: the shoelace consumers read a -1 slot as a zero point whose
    cross terms vanish, so the closing edge must be adjacent."""
    masks = masks.bool()
    b = masks.shape[0]
    cnt = masks.sum(-1, keepdim=True).clamp(min=1)
    cen = (pts * masks[..., None]).sum(-2) / cnt
    rel = pts - cen[:, None, :]
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    ang = torch.where(masks, ang, torch.inf)
    order = torch.argsort(ang, dim=-1, stable=True)
    valid = torch.gather(masks, -1, order)
    order = torch.where(valid, order, -1)
    if circular:
        order = torch.cat([order, order.new_full((b, 1), -1)], dim=-1)
        k = masks.sum(-1)
        rows = torch.arange(b, device=order.device)
        order[rows, k] = torch.where(k > 0, order[:, 0], -1)
    return order
