"""Bilinear sampling (counterpart of ``rs_detection_tpu/ops/sampling.py``):
``bilinear_sample_zeros``, the gather of the deformable convolution (zero
padding), and ``bilinear_sample``, the gather of R3Det's feature refine
(the reference's border band). Plain PyTorch: one row gather a corner;
autograd's backward of the gather adds into the features (with atomics
on the card, so two backward passes there may differ in the last bits).
The RoIAlign paths of the port sample inside their kernels."""

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


def bilinear_sample(feat, y, x):
    """Sample NHWC ``feat`` [N, H, W, C] at fractional points ``y``, ``x``
    (matching shapes [N, ...], image n's points in row n) -> [N, ..., C]
    with the reference ``bilinear_interpolate``'s border band: a point
    outside [-1, H] x [-1, W] gives 0; the rest are clamped to 0 below,
    and one that reaches the last row or column takes that pixel."""
    n, h, w, c = feat.shape
    flat = feat.reshape(n * h * w, c)
    base = (torch.arange(n, device=feat.device) * (h * w)).view(
        n, *([1] * (y.dim() - 1)))
    oob = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    # indices from coordinates held inside [0, H] (past it the point is
    # out of the band anyway; a NaN gives NaN weights, as in JAX)
    y_low = y.clamp(max=h).nan_to_num(0.0).long()
    x_low = x.clamp(max=w).nan_to_num(0.0).long()
    yc = y_low >= h - 1
    xc = x_low >= w - 1
    y_low = torch.where(yc, h - 1, y_low)
    x_low = torch.where(xc, w - 1, x_low)
    y_high = torch.where(yc, h - 1, y_low + 1)
    x_high = torch.where(xc, w - 1, x_low + 1)
    y = torch.where(yc, y_low.to(y.dtype), y)
    x = torch.where(xc, x_low.to(x.dtype), x)
    ly = (y - y_low.to(y.dtype))[..., None]
    lx = (x - x_low.to(x.dtype))[..., None]
    hy = 1.0 - ly
    hx = 1.0 - lx

    def at(yy, xx):
        return flat[base + yy * w + xx]

    out = (hy * hx * at(y_low, x_low) + hy * lx * at(y_low, x_high)
           + ly * hx * at(y_high, x_low) + ly * lx * at(y_high, x_high))
    return torch.where(oob[..., None], 0.0, out)
