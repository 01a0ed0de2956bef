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

import functools

import torch
import torch.nn.functional as F

from ._build import kernel_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The largest dynamic shared memory of one block and the SM count of an
# H100; `wgrad_plan` takes the device's own where there is one.
H100_SMEM, H100_SMS = 232448, 132
_DESIGNS = ("generic", "nhwc", "nchw")
# (k, dilation) of VAN's depthwise convs, which K6's two fast designs are
# built for; any other pair runs its first design
FAST_KD = ((3, 1), (5, 1), (7, 3))


def _nhwc_tile(k, d, itemsize):
    """(tile width, shared memory) of K6's NHWC design: 64 channels,
    8 x tw output pixels with their halo plus the g tile, two buffers
    where they fit (``NhwcShape`` in ``csrc/dw_wgrad.cu``)."""
    halo, pixel = (k - 1) * d, 64 * itemsize

    def pixels(tw):
        return (8 + halo) * (tw + halo) + 8 * tw

    tw = 16 if pixels(16) * pixel <= 200 * 1024 else 8
    buf = pixels(tw) * pixel
    nbuf = 2 if 2 * buf <= 224 * 1024 else 1
    return tw, max(nbuf * buf, 8 * k * k * 64 * 4)


def _nchw_smem(th, halo, w, itemsize):
    gw = -(-w // 8) * 8
    buf = ((th + halo) * (16 + gw + 16) + th * gw) * itemsize
    return max(2 * buf, 8 * 49 * 4)


def _nchw_band(halo, h, w, itemsize):
    """Rows of one band of K6's NCHW design (``nchw_band_rows``)."""
    th = min(h, max(1, 4096 // (-(-w // 8) * 8)))
    while th > 1 and _nchw_smem(th, halo, w, itemsize) > 96 * 1024:
        th = (th + 1) // 2
    return th


@functools.lru_cache(maxsize=None)
def _parts(ctiles, items, slots):
    """Blocks along the spatial axis of one K6 call. The grid is ctiles x
    parts blocks, ``slots`` of which run at a time, and a block walks
    ceil(items / parts) tiles: take the fewest parts that minimize waves
    x tiles per block (at most 512: each part is a row of partial sums)."""
    best, best_cost = 1, None
    for parts in range(1, min(items, 512) + 1):
        cost = -(-ctiles * parts // slots) * -(-items // parts)
        if best_cost is None or cost < best_cost:
            best, best_cost = parts, cost
    return best


def wgrad_plan(shape, x_strides, g_strides, k, d, itemsize,
               sms=H100_SMS, smem_limit=H100_SMEM):
    """How ``rs_dw_wgrad`` runs a call, mirrored from the launcher in
    ``csrc/dw_wgrad.cu``: the design the strides pick, one block's shared
    memory, the blocks along the channels, the spatial work items, and
    the ``parts`` this wrapper asks for."""
    n, c, h, w = shape
    halo = (k - 1) * d
    design, ctiles = "generic", -(-c // 32)
    items = n * -(-h // 16) * -(-w // 16)
    pixel = 32 * itemsize + 4
    smem = max(((16 + halo) ** 2 + 256) * pixel, 8 * k * k * 32 * 4)
    slots = None
    fast = (k, d) in FAST_KD
    if fast and x_strides[1] == 1 and g_strides[1] == 1:
        tw, smem = _nhwc_tile(k, d, itemsize)
        design, ctiles = "nhwc", -(-c // 64)
        items = n * -(-h // 8) * -(-w // tw)
        slots = sms * (2 if k < 7 and 2 * smem <= 224 * 1024 else 1)
    elif fast and x_strides[3] == 1 and g_strides[3] == 1:
        th = _nchw_band(halo, h, w, itemsize)
        if _nchw_smem(th, halo, w, itemsize) <= smem_limit:
            design, ctiles, items = "nchw", c, n * -(-h // th)
            smem, slots = _nchw_smem(th, halo, w, itemsize), 2 * sms
    if slots is None:  # ~2048 blocks in flight, about 15 per SM
        parts = max(1, min(items, 2048 // ctiles))
    else:
        parts = _parts(ctiles, items, slots)
    return dict(design=design, smem=smem, ctiles=ctiles, items=items,
                parts=parts)


def _memory_format(t):
    if t.is_contiguous():
        return torch.contiguous_format
    if t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    raise ValueError("dw_conv: tensors must be contiguous NCHW or "
                     "channels_last")


def dw_wgrad_reference(x, g, k: int, dilation: int = 1):
    """Plain tap loop: x, g [N, C, H, W] -> [k*k, C] f32 (taps row-major),
    products in f32, sums in f32 (f64 for f64 inputs)."""
    n, c, h, w = x.shape
    p = dilation * (k - 1) // 2
    xp = F.pad(x, (p, p, p, p))
    acc = torch.promote_types(x.dtype, torch.float32)
    gf = g.to(acc)
    taps = []
    for ky in range(k):
        for kx in range(k):
            sl = xp[:, :, ky * dilation:ky * dilation + h,
                    kx * dilation:kx * dilation + w]
            taps.append((sl.to(acc) * gf).sum(dim=(0, 2, 3)))
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
    props = torch.cuda.get_device_properties(x.device)
    limit = props.shared_memory_per_block_optin
    plan = wgrad_plan(x.shape, x.stride(), g.stride(), k, dilation,
                      x.element_size(), props.multi_processor_count, limit)
    if plan["smem"] > limit:
        raise ValueError(f"dw_wgrad kernel does not take k={k} dilation "
                         f"{dilation} in {x.dtype} (needs {plan['smem']} B "
                         f"of shared memory, limit {limit})")
    lib = kernel_library()
    parts = plan["parts"]
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


def launcher_plan(x, g, k: int, dilation: int = 1):
    """The plan of ``rs_dw_wgrad`` itself for CUDA tensors x and g (builds
    the library), in ``wgrad_plan``'s terms without ``parts``; the tests
    hold the two against each other."""
    import ctypes
    out = (ctypes.c_int * 4)()
    err = kernel_library().rs_dw_wgrad_plan(
        *x.stride(), *g.stride(), *x.shape, k, dilation,
        _DTYPE_CODE[x.dtype], out)
    if err != 0:
        raise ValueError(f"dw_wgrad: no plan for k={k}, {x.dtype}")
    return dict(design=_DESIGNS[out[0]], smem=out[1], ctiles=out[2],
                items=out[3])


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
