"""Horizontal-box NMS pieces of the RPN (counterpart of
``rs_detection_tpu/ops/nms.py``), batched over a leading image axis."""

from __future__ import annotations

import torch


def overlap_gt_mask_hbb(boxes, thresh: float, offset: float = 0.0):
    """Pairwise ``iou > thresh`` of hbbs ``[..., N, 4]`` -> ``[..., N, N]``
    bool, division-free: ``inter * (1 + t) > t * (a1 + a2)``."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    ix = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]) + offset)
    iy = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]) + offset)
    inter = torch.clamp(ix, min=0) * torch.clamp(iy, min=0)
    area = (x2 - x1 + offset) * (y2 - y1 + offset)
    return inter * (1.0 + thresh) > thresh * (area[..., :, None]
                                              + area[..., None, :])


def greedy_suppress_mask(over, order_valid):
    """Greedy NMS keep mask of score-sorted boxes from their pairwise
    overlap mask ``over [..., N, N]`` and validity ``[..., N]``.

    Jacobi fixpoint, as ``_greedy_suppress_mask`` in the JAX package:
    every sweep recomputes all keeps from the last ones, and after t
    sweeps every box whose suppression chain is at most t long is
    final, so the loop ends at the exact sequential-greedy result."""
    n = over.shape[-1]
    upper = torch.ones(n, n, dtype=torch.bool, device=over.device).triu(1)
    m = over & upper & order_valid[..., :, None] & order_valid[..., None, :]
    keep = order_valid
    for _ in range(n):
        sup = (m & keep[..., :, None]).any(dim=-2)
        new = order_valid & ~sup
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def top_k(x, k: int):
    """Exact top-k along the last axis, ties to the lower index (the
    order ``jax.lax.top_k`` gives). The TPU path's ``fast_top_k`` is
    approximate above 16384 candidates; the port is exact everywhere."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
