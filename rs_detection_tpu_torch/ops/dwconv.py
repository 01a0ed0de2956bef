"""Depthwise K x K dilated convolution, SAME padding, stride 1, as a
hand-written kernel in two layouts.

Counterpart of ``rs_detection_tpu/ops/pallas_dwconv.py``
(``depthwise_conv2d``: x ``[N, H, W, C]``, w ``[K, K, C]``) and of the
prototype ``tools/analysis_tools/chw_dw_proto.py`` (``dw_chw``: x
``[N, H, C, W]``, wts ``[C, k*k]``). Both are one kernel template,
``csrc/dw_conv_fwd.cu``, with the layout as a template parameter; taps
accumulate in f32 and round once to the output dtype. The same kernel,
with a bias, runs the two depthwise convs inside the fused VAN attention
half-block (``ops/van_attn.py``).

``depthwise_conv2d`` is differentiable like the JAX op (which has a
``custom_vjp``): ``dx`` is the same kernel on the gradient with the
spatially flipped taps (the adjoint at stride 1), ``dw`` is the K6
kernel through ``ops/dw_conv.py:dw_wgrad``. On a CPU tensor every part
takes its plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import kernel_library
from .dw_conv import dw_wgrad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rows_per_thread(k: int) -> int:
    """Outputs per thread along the rows (the kernel takes 1 or 4): 4
    reuses each value loaded from shared memory for up to 4 taps, which
    pays at k = 5 and 7; at k = 3 it measured slower than 1 on the H100
    (PERF.md)."""
    return 4 if k > 3 else 1


def _pad(k: int, dilation: int) -> int:
    return dilation * (k - 1) // 2


def depthwise_conv2d_reference(x, w, k: int = 5, dilation: int = 1):
    """Plain version: x [N, H, W, C], w [K, K, C] -> [N, H, W, C] through
    ``F.conv2d`` with ``groups=C``."""
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2),
                 w.to(x.dtype).permute(2, 0, 1).reshape(c, 1, k, k),
                 padding=_pad(k, dilation), dilation=dilation, groups=c)
    return y.permute(0, 2, 3, 1)


def dw_chw_reference(x, wts, k: int, dil: int):
    """Plain version of the prototype's layout: x [N, H, C, W], wts
    [C, k*k] -> [N, H, C, W]."""
    c = x.shape[2]
    y = F.conv2d(x.permute(0, 2, 1, 3), wts.to(x.dtype).reshape(c, 1, k, k),
                 padding=_pad(k, dil), dilation=dil, groups=c)
    return y.permute(0, 2, 1, 3)


def _launch(wrapper, name, x, w, bias, k, dilation, c, w_tap, w_ch, hcw):
    """Check the operands and launch ``rs_dw_conv_fwd``, counting the
    launch on ``wrapper``; ``w`` holds tap t of channel ch at
    ``t * w_tap + ch * w_ch``."""
    tensors = [("x", x), ("w", w)] + ([("bias", bias)] if bias is not None
                                      else [])
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in tensors):
        raise RuntimeError(f"{name}: an input requires a gradient; autograd "
                           f"does not see the kernel launch (use "
                           f"depthwise_conv2d)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if k not in (3, 5, 7) or dilation < 1:
        raise ValueError(f"{name} kernel takes k in (3, 5, 7) and dilation "
                         f">= 1, got k={k}, dilation={dilation}")
    for label, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if w.numel() != k * k * c or (bias is not None and bias.numel() != c):
        raise ValueError(f"{name}: w {tuple(w.shape)} / bias do not match "
                         f"k={k}, C={c}")
    code = _DTYPE_CODE[x.dtype]
    lib = kernel_library()
    rows = _rows_per_thread(k)
    smem = lib.rs_dw_conv_fwd_smem_bytes(k, rows, dilation, code, hcw)
    limit = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{name} kernel does not take k={k} dilation "
                         f"{dilation} in {x.dtype} (needs {smem} B of shared "
                         f"memory, limit {limit})")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    n, h = x.shape[0], x.shape[1]
    width = x.shape[3] if hcw else x.shape[2]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        wrapper.launches += 1
        err = lib.rs_dw_conv_fwd(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), n, h,
            width, c, k, dilation, w_tap, w_ch, rows, code, hcw, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return y


def depthwise_conv2d_cuda(x, w, k: int = 5, dilation: int = 1, bias=None,
                          taps_last: bool = False):
    """Launch the kernel on CUDA tensors: x [N, H, W, C] contiguous, w
    [K, K, C] (or ``[C, K*K]``, the ``nn.Conv2d`` layout, with
    ``taps_last``), optional bias [C], all f32 or bf16."""
    if x.dim() != 4:
        raise ValueError(f"depthwise_conv2d: x {tuple(x.shape)} is not "
                         f"[N, H, W, C]")
    c = x.shape[3]
    return _launch(depthwise_conv2d_cuda, "depthwise_conv2d", x, w, bias, k,
                   dilation, c, *((1, k * k) if taps_last else (c, 1)), 0)


depthwise_conv2d_cuda.launches = 0


def dw_chw_cuda(x, wts, k: int, dil: int):
    """Launch the kernel's ``[N, H, C, W]`` form on CUDA tensors: wts
    [C, k*k]."""
    if x.dim() != 4:
        raise ValueError(f"dw_chw: x {tuple(x.shape)} is not [N, H, C, W]")
    c = x.shape[2]
    return _launch(dw_chw_cuda, "dw_chw", x, wts, None, k, dil, c, 1, k * k,
                   1)


dw_chw_cuda.launches = 0


def _forward(x, w, k, dilation):
    if x.is_cuda:
        return depthwise_conv2d_cuda(x, w.to(x.dtype).contiguous(), k,
                                     dilation)
    if x.device.type == "cpu":
        return depthwise_conv2d_reference(x, w, k, dilation)
    raise ValueError(f"depthwise_conv2d: no implementation for device "
                     f"{x.device}")


class _DepthwiseConv2d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, k, dilation):
        ctx.save_for_backward(x, w)
        ctx.k, ctx.dilation = k, dilation
        return _forward(x, w, k, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, d = ctx.k, ctx.dilation
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _forward(g, w.flip((0, 1)), k, d)
        if ctx.needs_input_grad[1]:
            # K6 reads logical NCHW through its strides: these are views
            dw = dw_wgrad(x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), k, d) \
                .reshape(k, k, -1).to(w.dtype)
        return dx, dw, None, None


def depthwise_conv2d(x, w, k: int = 5, dilation: int = 1):
    """Depthwise 2-D conv, SAME padding, stride 1, no bias: x
    [N, H, W, C], w [K, K, C] -> [N, H, W, C]. The kernel for a CUDA
    ``x``, the plain version for a CPU ``x``; differentiable in both."""
    if tuple(w.shape) != (k, k, x.shape[-1]):
        raise ValueError(f"depthwise_conv2d: w {tuple(w.shape)} is not "
                         f"[{k}, {k}, {x.shape[-1]}]")
    return _DepthwiseConv2d.apply(x, w, k, dilation)


def dw_chw(x, wts, k: int, dil: int):
    """The prototype's layout: x [N, H, C, W], wts [C, k*k] ->
    [N, H, C, W]. The kernel for a CUDA ``x``, the plain version for a
    CPU ``x``; forward only, like the prototype."""
    if x.is_cuda:
        return dw_chw_cuda(x, wts, k, dil)
    if x.device.type == "cpu":
        return dw_chw_reference(x, wts, k, dil)
    raise ValueError(f"dw_chw: no implementation for device {x.device}")
