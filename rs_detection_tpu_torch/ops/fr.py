"""Feature refinement of R3Det (counterpart of
``rs_detection_tpu/ops/fr.py``): each cell's features plus the features
bilinearly sampled at its refined box's centre (``points`` 1) or centre
and four corners (``points`` 5). Boxes are plain (cx, cy, w, h, theta),
as in the JAX function; the reference kernel's buffers are (y, x, w, h,
a)-ordered at its boundary (``tests/test_torch_parity_fr.py``).

Plain PyTorch on every device: the JAX function is a plain XLA gather,
no Pallas call. Its backward is autograd's scatter-add through the
gather (atomics on the card), as JAX's autodiff is."""

from __future__ import annotations

import torch

from .sampling import bilinear_sample


def feature_refine(features, best_rbboxes, spatial_scale: float,
                   points: int = 1):
    """features [N, H, W, C], best_rbboxes [N, H, W, 5] (image
    coordinates) -> [N, H, W, C]: the features plus the sum of the
    sampled points (``spatial_scale`` maps a box to the feature map)."""
    if points not in (1, 5):
        raise ValueError(f"feature_refine: points {points}, not 1 or 5")
    cx = best_rbboxes[..., 0] * spatial_scale
    cy = best_rbboxes[..., 1] * spatial_scale
    acc = bilinear_sample(features, cy, cx)
    if points == 5:
        w2 = best_rbboxes[..., 2] * spatial_scale / 2.0
        h2 = best_rbboxes[..., 3] * spatial_scale / 2.0
        a = best_rbboxes[..., 4]
        cosa, sina = torch.cos(a), torch.sin(a)
        wx, wy = cosa * w2, sina * w2
        hx, hy = -sina * h2, cosa * h2
        for sx, sy in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
            px = cx + sx * wx + sy * hx
            py = cy + sx * wy + sy * hy
            acc = acc + bilinear_sample(features, py, px)
    return features + acc
