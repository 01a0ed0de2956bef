"""Depthwise conv with a hand-written weight gradient.

Counterpart of ``rs_detection_tpu/ops/dw_conv.py:dw_conv`` with its
custom backward on (``RS_DW_TAP_BWD=1``, ``RS_DW_WGRAD_PALLAS=1``), the
only depthwise conv of VAN's training step: dw3 in the MLP, dw5 and dw7
dilation 3 in the attention. Stride 1, symmetric SAME padding
``p = d * (k - 1) // 2``.

* forward: the grouped conv (cuDNN on CUDA);
* ``dx``: the grouped conv of the gradient with the spatially flipped
  kernel at the same padding and dilation, which is the forward's adjoint
  at stride 1;
* ``dw``: ``dw[ky, kx, c] = sum xpad[n, c, y + ky*d, x + kx*d] *
  g[n, c, y, x]``, the K6 kernel (``csrc/dw_wgrad.cu``) for CUDA tensors,
  the plain tap loop ``dw_wgrad_reference`` for CPU tensors;
* ``db``: the gradient summed over N, H, W in f32.

Tensors are PyTorch's logical NCHW in either memory format; K6 reads both
through their strides. Only ``dx`` needs the gradient in the input's
format (cuDNN runs the dilated 7x7 far slower in channels_last, PERF.md),
so the backward converts the gradient when autograd hands it over in the
other one: one copy of the gradient, mirroring the forward's layout copy
around the NCHW dilated conv (``ops/van_attn.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import kernel_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# blocks along the spatial axis of one K6 call: with the channel tiles
# this keeps ~2048 blocks in flight (about 15 per SM) while the partial
# sums stay a few MB
_TARGET_BLOCKS = 2048
_TILE = 16
_CT = 32


def _memory_format(t):
    if t.is_contiguous():
        return torch.contiguous_format
    if t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    raise ValueError("dw_conv: tensors must be contiguous NCHW or "
                     "channels_last")


def dw_wgrad_reference(x, g, k: int, dilation: int = 1):
    """Plain tap loop: x, g [N, C, H, W] -> [k*k, C] f32 (taps row-major),
    products in f32, sums in f32."""
    n, c, h, w = x.shape
    p = dilation * (k - 1) // 2
    xp = F.pad(x, (p, p, p, p))
    gf = g.float()
    taps = []
    for ky in range(k):
        for kx in range(k):
            sl = xp[:, :, ky * dilation:ky * dilation + h,
                    kx * dilation:kx * dilation + w]
            taps.append((sl.float() * gf).sum(dim=(0, 2, 3)))
    return torch.stack(taps)


def dw_wgrad_cuda(x, g, k: int, dilation: int = 1):
    """Launch K6 on CUDA tensors: x, g [N, C, H, W] of one dtype (f32 or
    bf16), each contiguous NCHW or channels_last -> [k*k, C] f32."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad):
        raise RuntimeError("dw_wgrad_cuda: an input requires a gradient; K6 "
                           "has no backward of its own")
    if x.dtype not in _DTYPE_CODE or g.dtype != x.dtype:
        raise TypeError(f"dw_wgrad kernel takes f32 or bf16 x and g of one "
                        f"dtype, got {x.dtype} and {g.dtype}")
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"dw_wgrad: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} must be one [N, C, H, W] shape")
    if not x.is_cuda or g.device != x.device:
        raise ValueError(f"dw_wgrad: x on {x.device}, g on {g.device}")
    if k not in (3, 5, 7) or dilation < 1:
        raise ValueError(f"dw_wgrad kernel takes k in (3, 5, 7) and "
                         f"dilation >= 1, got k={k}, dilation={dilation}")
    _memory_format(x)
    _memory_format(g)
    n, c, h, w = x.shape
    code = _DTYPE_CODE[x.dtype]
    lib = kernel_library()
    smem = lib.rs_dw_wgrad_smem_bytes(k, dilation, code)
    limit = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"dw_wgrad kernel does not take k={k} dilation "
                         f"{dilation} in {x.dtype} (needs {smem} B of shared "
                         f"memory, limit {limit})")
    tiles = n * -(-h // _TILE) * -(-w // _TILE)
    parts = max(1, min(tiles, _TARGET_BLOCKS // -(-c // _CT)))
    partial = torch.empty(parts, k * k, c, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(k * k, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        dw_wgrad_cuda.launches += 1
        err = lib.rs_dw_wgrad(x.data_ptr(), g.data_ptr(), *x.stride(),
                              *g.stride(), n, c, h, w, k, dilation, code,
                              parts, partial.data_ptr(), out.data_ptr(),
                              stream)
    if err != 0:
        raise RuntimeError(f"dw_wgrad kernel launch failed: CUDA error {err}")
    return out


dw_wgrad_cuda.launches = 0


def dw_wgrad(x, g, k: int, dilation: int = 1):
    """Depthwise weight gradient [k*k, C] f32: K6 for CUDA tensors, the
    tap loop for CPU tensors."""
    if x.is_cuda:
        return dw_wgrad_cuda(x, g, k, dilation)
    if x.device.type == "cpu":
        return dw_wgrad_reference(x, g, k, dilation)
    raise ValueError(f"dw_wgrad: no implementation for device {x.device}")


class _DWConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, dilation):
        c, k = x.shape[1], w.shape[-1]
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        ctx.has_bias = b is not None
        return F.conv2d(x, w, b, padding=dilation * (k - 1) // 2,
                        dilation=dilation, groups=c)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        c, k = x.shape[1], w.shape[-1]
        fmt = _memory_format(x)
        if not g.is_contiguous(memory_format=fmt):
            g = g.contiguous(memory_format=fmt)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = F.conv2d(g, w.flip((2, 3)), padding=d * (k - 1) // 2,
                          dilation=d, groups=c)
        if ctx.needs_input_grad[1]:
            dw = dw_wgrad(x, g, k, d).t().reshape(c, 1, k, k).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3), dtype=torch.float32).to(w.dtype)
        return dx, dw, db, None


def dw_conv(x, w, b=None, dilation: int = 1):
    """Depthwise conv of x [N, C, H, W] with w [C, 1, k, k] (the
    ``nn.Conv2d`` layout) and optional bias [C]; stride 1, SAME
    symmetric padding. Its weight gradient is K6 on CUDA."""
    return _DWConv.apply(x, w, b, dilation)
