"""Depthwise K x K dilated convolution, SAME padding, stride 1, as a
hand-written kernel in two layouts.

Counterpart of ``rs_detection_tpu/ops/pallas_dwconv.py``
(``depthwise_conv2d``: x ``[N, H, W, C]``, w ``[K, K, C]``) and of the
prototype ``tools/analysis_tools/chw_dw_proto.py`` (``dw_chw``: x
``[N, H, C, W]``, wts ``[C, k*k]``). The kernel has two designs, picked
by ``dw_plan`` from the shape and dtype: the streaming design of
``csrc/dw_conv_fwd_stream.cu`` for bf16 NHWC at (k, d) = (5, 1) and
(7, 3), VAN's attention convs; the row-streaming design of
``csrc/dw_conv_chw.cu`` for bf16 ``[N, H, C, W]`` with W a multiple of 8
at dilation 1-3 (K7's form: a warp per channel and 256-column strip,
taps, inputs and sums in registers); and the first design,
``csrc/dw_conv_fwd.cu`` (one kernel template with the layout as a
template parameter), for everything else; taps accumulate in f32 and
round once to the output dtype in all three. The same kernels, with a bias,
run the two depthwise convs inside the fused VAN attention half-block
(``ops/van_attn.py``).

``depthwise_conv2d`` is differentiable like the JAX op (which has a
``custom_vjp``): ``dx`` is the same kernel on the gradient with the
spatially flipped taps (the adjoint at stride 1), ``dw`` is the K6
kernel through ``ops/dw_conv.py:dw_wgrad``. On a CPU tensor every part
takes its plain version.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ._build import kernel_library
from .dw_conv import H100_SMEM, H100_SMS, dw_wgrad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
H100_SMEM_PER_SM = 233472  # shared memory of one SM
# the streaming design's builds: warps per block (column groups of 4
# outputs spaced d apart) for each (k, d), two blocks to an SM; at (7, 3)
# 6 measured faster than 9 or 12 at one block to an SM (PERF.md)
STREAM_WARPS = {(5, 1): 8, (7, 3): 6}
STREAM_ROWS = STREAM_COLS = 4   # outputs per thread along rows / columns
STREAM_STAGES = 3               # steps of 4 rows in a block's ring
# the [N, H, C, W] row-streaming design: dilations it is built for, warps
# per block, output columns per warp (8 per lane), and the warps one SM
# holds by k (blocks of 4 warps that fit its registers: ptxas gives 63-72,
# 96-120 and 154-168 registers a thread at k = 3, 5, 7)
CHW_DILATIONS = (1, 2, 3)
CHW_WARPS = 4
CHW_STRIP = 256
CHW_WARPS_PER_SM = {3: 24, 5: 16, 7: 12}


def _chw_plan(k: int, d: int, h: int, w: int, c: int, n: int, sms: int):
    """The ``[N, H, C, W]`` row-streaming design's launch: one warp per
    (image, row segment, row class mod d, 256-column strip, channel);
    the segments that take the fewest input rows of the busiest warp
    slot: waves x (rows per segment + k - 1, a segment's first rows)."""
    strips = -(-w // CHW_STRIP)
    base = n * d * strips * c
    rows = -(-h // d)  # output rows of the largest row class
    best = None
    for segs in range(1, rows + 1):
        per = -(-rows // segs)
        segs = -(-rows // per)
        cost = -(-(base * segs) // (sms * CHW_WARPS_PER_SM[k])) \
            * (per + k - 1)
        if best is None or cost < best[0]:
            best = (cost, segs, per)
    _, segs, per = best
    return dict(design="chw", strips=strips, segs=segs, seg_rows=per,
                warps=base * segs, blocks=-(-base * segs // CHW_WARPS),
                smem=0)


def _rows_per_thread(k: int) -> int:
    """Outputs per thread along the rows in the first design (1 or 4): 4
    reuses each value loaded from shared memory for up to 4 taps, which
    pays at k = 5 and 7; at k = 3 it measured slower than 1 on the H100
    (PERF.md)."""
    return 4 if k > 3 else 1


def _first_smem(k: int, d: int, itemsize: int, hcw: bool) -> int:
    """Shared memory of one block of the first design
    (``dw_conv_fwd.cu:smem_bytes``)."""
    rows = _rows_per_thread(k)
    halo = (k - 1) * d
    th = rows * d * max(1, 16 // (rows * d))
    ct, tw = (8, 32) if hcw else (32, 16)
    return (th + halo) * (tw + halo) * ct * itemsize


def _stream_smem(k: int, d: int, groups: int) -> int:
    """Shared memory of one streaming block: a ring of 3 * 4 + k - 1
    input rows of (4 * groups + (k - 1) d) pixels x 64 bf16 channels,
    and the block's k * k x 64 taps in f32
    (``dw_conv_fwd_stream.cu:StreamGeom``)."""
    ring = STREAM_STAGES * STREAM_ROWS + k - 1
    return ring * (groups * STREAM_COLS + (k - 1) * d) * 64 * 2 \
        + k * k * 64 * 4


def dw_plan(k: int, d: int, h: int, w: int, c: int, dtype, n: int = 1,
            hcw: bool = False, aligned: bool = True, sms: int = H100_SMS,
            smem_limit: int = H100_SMEM,
            smem_per_sm: int = H100_SMEM_PER_SM):
    """How the depthwise forward runs x [n, h, w, c] (``hcw``: the
    ``[N, H, C, W]`` form) with a k x k kernel at dilation d, mirrored
    from the launchers in ``csrc/``. ``"stream"`` (bf16 NHWC, (k, d) in
    ``STREAM_WARPS``, c a multiple of 8, x 16-byte aligned): the warps
    per block ``groups`` (a strip of ``tw`` = 4 * groups output
    columns), the ring of ``ring_rows`` input rows in ``stages`` steps of
    4 rows, ``smem``, ``blocks_per_sm`` and the row segments (``segs`` of
    ``seg_steps`` steps) that take the fewest steps of the busiest SM:
    waves x (steps + 1, a segment's first rows). ``"chw"`` (bf16
    ``hcw``, w a multiple of 8, x 16-byte aligned, d in
    ``CHW_DILATIONS``): ``strips`` of 256 columns, row ``segs`` of
    ``seg_rows`` output rows per row class, ``warps`` and ``blocks``.
    ``"first"`` otherwise: rows per thread and ``smem``. Raises
    ``ValueError`` for what no design takes."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"depthwise kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    if k not in (3, 5, 7) or d < 1:
        raise ValueError(f"depthwise kernel takes k in (3, 5, 7) and "
                         f"dilation >= 1, got k={k}, dilation={d}")
    if hcw and dtype == torch.bfloat16 and w % 8 == 0 and aligned \
            and d in CHW_DILATIONS:
        return _chw_plan(k, d, h, w, c, n, sms)
    groups = STREAM_WARPS.get((k, d)) if (
        dtype == torch.bfloat16 and not hcw and c % 8 == 0 and aligned) \
        else None
    smem = _stream_smem(k, d, groups) if groups else None
    if groups and smem <= smem_limit:
        per_sm = min(2, smem_per_sm // (smem + 1024))
        tw = groups * STREAM_COLS
        strips = -(-w // tw)
        base = n * -(-c // 64) * strips * d
        rows = -(-h // d)  # output rows of the largest row class
        steps = -(-rows // STREAM_ROWS)
        best = None
        for segs in range(1, steps + 1):
            per = -(-steps // segs)
            segs = -(-steps // per)
            cost = -(-(base * segs) // (sms * per_sm)) * (per + 1)
            if best is None or cost < best[0]:
                best = (cost, segs, per)
        _, segs, per = best
        return dict(design="stream", groups=groups, tw=tw, strips=strips,
                    ring_rows=STREAM_STAGES * STREAM_ROWS + k - 1,
                    stages=STREAM_STAGES, smem=smem, blocks_per_sm=per_sm,
                    segs=segs, seg_steps=per, blocks=base * segs)
    smem = _first_smem(k, d, 4 if dtype == torch.float32 else 2, hcw)
    if smem > smem_limit:
        raise ValueError(f"depthwise kernel does not take k={k} dilation "
                         f"{d} in {dtype} (needs {smem} B of shared "
                         f"memory, limit {smem_limit})")
    return dict(design="first", rows=_rows_per_thread(k), smem=smem)


@functools.lru_cache(maxsize=None)
def _device_limits(index: int):
    """(SMs, shared memory one block may ask for, shared memory of an SM)
    of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count, props.shared_memory_per_block_optin,
            props.shared_memory_per_multiprocessor)


# a launch reads its plan here: planning costs more host time than a small
# launch takes on the card
_cached_plan = functools.lru_cache(maxsize=4096)(dw_plan)


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


def dw_chw_stream_reference(x, wts, k: int, dil: int, segs: int,
                            seg_rows: int, bias=None):
    """Plain version of the ``[N, H, C, W]`` row-streaming design, in its
    order: per row class rho mod ``dil`` and segment of ``seg_rows``
    output rows, the input rows of the class one after the other, each
    added (f32, taps left to right) into the k output rows it touches
    (kept here in a ring of k); an output row is rounded once when its
    last input row is in. Same function as ``dw_chw_reference``, for the CPU tests of the
    design's row and segment arithmetic."""
    n, h, c, w = x.shape
    pad = _pad(k, dil)
    xp = F.pad(x.float(), (pad, pad))
    taps = wts.float().reshape(c, k * k)[None, :, None, :]
    init = torch.zeros(n, c, w) if bias is None \
        else bias.float()[None, :, None].expand(n, c, w)
    y = torch.empty(n, h, c, w)
    for rho in range(dil):
        rows = -(-(h - rho) // dil)
        for seg in range(segs):
            i0, i1 = seg * seg_rows, min(rows, (seg + 1) * seg_rows)
            if i0 >= i1:
                continue
            acc = [init.clone() for _ in range(k)]
            for u in range(i1 - i0 + k - 1):
                gy = rho - pad + dil * (i0 + u)
                if 0 <= gy < h:
                    row = xp[:, gy]
                    for ky in range(k):
                        a = acc[(u - ky) % k]
                        for kx in range(k):
                            a += row[..., kx * dil:kx * dil + w] \
                                * taps[..., ky * k + kx]
                if u >= k - 1:
                    y[:, rho + dil * (i0 + u - k + 1)] = acc[(u + 1) % k]
                acc[(u + 1) % k] = init.clone()
    return y.to(x.dtype)


def _launch(wrapper, name, x, w, bias, k, dilation, c, w_tap, w_ch, hcw):
    """Check the operands and launch the design ``dw_plan`` picks,
    counting the launch on ``wrapper``; ``w`` holds tap t of channel ch
    at ``t * w_tap + ch * w_ch``."""
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
    n, h = x.shape[0], x.shape[1]
    width = x.shape[3] if hcw else x.shape[2]
    sms, smem_limit, smem_per_sm = _device_limits(x.device.index)
    plan = _cached_plan(k, dilation, h, width, c, x.dtype, n=n,
                        hcw=bool(hcw), aligned=x.data_ptr() % 16 == 0,
                        sms=sms, smem_limit=smem_limit,
                        smem_per_sm=smem_per_sm)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    args = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), n, h,
            width, c, k, dilation, w_tap, w_ch)
    lib = kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        wrapper.launches += 1
        if plan["design"] == "stream":
            err = lib.rs_dw_conv_fwd_stream(*args, plan["groups"],
                                            plan["segs"], plan["seg_steps"],
                                            stream)
        elif plan["design"] == "chw":
            err = lib.rs_dw_conv_chw(*args, plan["segs"], plan["seg_rows"],
                                     stream)
        else:
            err = lib.rs_dw_conv_fwd(*args, plan["rows"],
                                     _DTYPE_CODE[x.dtype], hcw, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return y


def depthwise_conv2d_first_design(x, w, k: int, dilation: int = 1,
                                  bias=None, taps_last: bool = False):
    """``depthwise_conv2d_cuda``'s operands through the first design
    (``csrc/dw_conv_fwd.cu``) whatever ``dw_plan`` picks: for timing the
    two designs side by side. Not counted; checks the device and dtype
    of x, the launcher the rest."""
    if not x.is_cuda:
        raise ValueError(f"depthwise first design: x is on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"depthwise kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    c = x.shape[3]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = kernel_library().rs_dw_conv_fwd(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], x.shape[2], c, k, dilation,
            *((1, k * k) if taps_last else (c, 1)), _rows_per_thread(k),
            _DTYPE_CODE[x.dtype], 0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"depthwise first design launch failed: CUDA "
                           f"error {err}")
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


def dw_chw_first_design(x, wts, k: int, dil: int):
    """``dw_chw_cuda``'s operands through the first design
    (``csrc/dw_conv_fwd.cu`` in its ``[N, H, C, W]`` form) whatever
    ``dw_plan`` picks: for timing the two designs side by side. Not
    counted; checks the device and dtype of x, the launcher the rest."""
    if not x.is_cuda:
        raise ValueError(f"dw_chw first design: x is on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"depthwise kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    n, h, c, w = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = kernel_library().rs_dw_conv_fwd(
            x.data_ptr(), wts.data_ptr(), None, y.data_ptr(), n, h, w, c, k,
            dil, 1, k * k, _rows_per_thread(k), _DTYPE_CODE[x.dtype], 1,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dw_chw first design launch failed: CUDA error "
                           f"{err}")
    return y


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
