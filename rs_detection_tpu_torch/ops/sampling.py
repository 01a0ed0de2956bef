"""Bilinear sampling with zero padding (counterpart of
``rs_detection_tpu/ops/sampling.py:bilinear_sample_zeros``), the gather
of the deformable convolution. Plain PyTorch: one row gather a corner;
autograd's backward of the gather adds into the features (with atomics
on the card, so two backward passes there may differ in the last bits).
Only the zero-padding form is ported: the RoIAlign paths of the port
sample inside their kernels."""

from __future__ import annotations

import torch


def bilinear_sample_zeros(feat, y, x):
    """Sample NHWC ``feat`` [N, H, W, C] at fractional points ``y``, ``x``
    (matching shapes [N, ...], image n's points in row n) -> [N, ..., C].

    Each of the four neighbours contributes its bilinear weight only
    where it lies inside the image, as the reference's
    ``deformable_im2col`` and ordinary zero padding do."""
    n, h, w, c = feat.shape
    flat = feat.reshape(n * h * w, c)
    base = (torch.arange(n, device=feat.device) * (h * w)).view(
        n, *([1] * (y.dim() - 1)))
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ly = (y - y0)[..., None]
    lx = (x - x0)[..., None]
    y0i = y0.long()
    x0i = x0.long()
    out = 0.0
    for dy, wy in ((0, 1.0 - ly), (1, ly)):
        for dx, wx in ((0, 1.0 - lx), (1, lx)):
            yy = y0i + dy
            xx = x0i + dx
            ok = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
            v = flat[base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]
            out = out + torch.where(ok, wy * wx * v, 0.0)
    return out
