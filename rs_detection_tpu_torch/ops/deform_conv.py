"""Deformable convolution, v1 and v2 (counterpart of
``rs_detection_tpu/ops/deform_conv.py:deform_conv2d``), plain PyTorch:
every deformed tap is a bilinear gather (``sampling.
bilinear_sample_zeros``) into an [N, Ho, Wo, K*K*C] column tensor, then
one product with the weight. Gradients for the input, the weight and
the mask come from autograd; S2ANet's AlignConv detaches its offsets.
The JAX package has no Pallas kernel here, and the port no CUDA one.

Offsets are laid out as in the reference and torchvision: channels
``[dg, K*K, 2]`` with (dy, dx) pairs a tap, taps row-major (y outer).
The weight is OIHW, ``[Cout, C, kh, kw]``, the layout the weight carrier
gives the JAX package's HWIO kernel; the contraction reads it tap-major,
``(ky, kx, c)``, the order in which JAX reshapes the HWIO kernel to
``[K*K*C, Cout]``.
"""

from __future__ import annotations

import torch

from .sampling import bilinear_sample_zeros


def deform_conv2d(x, offset, weight, bias=None, mask=None,
                  kernel_size: int = 3, stride: int = 1, padding: int = 1,
                  dilation: int = 1, deform_groups: int = 1):
    """x [N, H, W, C]; offset [N, Ho, Wo, 2 * dg * K * K] (dy, dx); weight
    [Cout, C, K, K]; mask [N, Ho, Wo, dg * K * K] (v2) or None (v1) ->
    [N, Ho, Wo, Cout] in x's dtype."""
    k = kernel_size
    n, h, w, c = x.shape
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    dg = deform_groups
    if c % dg:
        raise ValueError(f"deform_conv2d: {c} channels in {dg} groups")
    off = offset.reshape(n, ho, wo, dg, k * k, 2)
    f32 = dict(dtype=torch.float32, device=x.device)
    base_y = torch.arange(ho, **f32) * stride - padding
    base_x = torch.arange(wo, **f32) * stride - padding
    taps = torch.arange(k, **f32) * dilation
    ky = taps.repeat_interleave(k)
    kx = taps.repeat(k)
    py = base_y[:, None, None] + ky                  # [Ho, 1, K*K]
    px = base_x[None, :, None] + kx                  # [1, Wo, K*K]
    m = None if mask is None else mask.reshape(n, ho, wo, dg, k * k)
    cg = c // dg
    cols = []
    for g in range(dg):
        vals = bilinear_sample_zeros(x[..., g * cg:(g + 1) * cg],
                                     py + off[..., g, :, 0],
                                     px + off[..., g, :, 1])
        if m is not None:
            vals = vals * m[..., g, :, None]
        cols.append(vals)                            # [N, Ho, Wo, K*K, cg]
    cols = torch.cat(cols, dim=-1).reshape(n, ho, wo, k * k * c)
    wmat = weight.permute(2, 3, 1, 0).reshape(k * k * c, -1)
    out = cols @ wmat.to(cols.dtype)
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def dcn_offset_grid(k: int):
    """The (ky, kx) tap offsets of a k x k kernel in row-major tap order,
    f32 [k * k] each (AlignConv's offset builder)."""
    ky = torch.arange(k, dtype=torch.float32).repeat_interleave(k)
    kx = torch.arange(k, dtype=torch.float32).repeat(k)
    return ky, kx
