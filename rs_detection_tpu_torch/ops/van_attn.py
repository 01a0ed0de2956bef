"""VAN spatial attention, counterpart of
``rs_detection_tpu/ops/pallas_van_attn.py``.

``sa_core`` is the attention body (the JAX ``_sa_core``), plain PyTorch
around ``dw_conv``, whose weight gradient is the K6 kernel on CUDA; the
non-fused VAN block and training run it. Its ``int8`` argument is the
int8 serving mode of the three 1x1 mixes (``ops/quant.py``); the fused
half-block below has no int8 form, as the JAX ``_attn_kernel`` has none.

``van_attn`` is the fused attention half-block of the fused serving mode
(the JAX ``van_attn``, opt-in there as here): eval-mode bn1 folded to an
affine, the attention body, the layer scale and the block's residual
add. On a CUDA tensor it runs as four hand-written kernels, every
multiply-add in ``csrc/``: ``proj1`` (``csrc/van_attn.cu``: affine,
proj_1, GELU), the 5x5 and the dilated 7x7 depthwise convs with their
biases (``csrc/dw_conv_fwd.cu`` through ``depthwise_conv2d_cuda``) and
``tail`` (``csrc/van_attn.cu``: conv1, the gate, proj_2, ``+ h``, layer
scale, ``+ x``). On a CPU tensor it runs ``van_attn_reference``, the
JAX ``_ref_attn``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import kernel_library
from .activations import exact_gelu
from .dw_conv import dw_conv
from .dwconv import depthwise_conv2d_cuda
from .quant import int8_channel_matmul

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def sa_core(h, wp1, bp1, w0, b0, ws, bs, wc1, bc1, wp2, bp2, int8=False):
    """``proj_2(g * conv1(dw7d3(dw5(g)))) + h`` with
    ``g = gelu(proj_1(h))``, the module's inner shortcut included.

    ``h`` is NHWC ``[N, H, W, C]``; the weights are as ``nn.Conv2d``
    holds them: 1x1 ``[C, C, 1, 1]``, depthwise ``[C, 1, k, k]``.
    Returns NHWC (a view of a channels-last NCHW result). With ``int8``
    (serving) the three 1x1 mixes run as ``int8_channel_matmul``; the
    depthwise convs, the GELU, the gate and the shortcut stay in h's
    dtype."""
    x = h.permute(0, 3, 1, 2)
    if int8:
        def mix(t, w, b):   # NCHW view of an NHWC product
            c = w.shape[0]
            return int8_channel_matmul(t.permute(0, 2, 3, 1), w.view(c, c),
                                       b).permute(0, 3, 1, 2)
    else:
        def mix(t, w, b):
            return F.conv2d(t, w, b)
    g = exact_gelu(mix(x, wp1, bp1))
    d5 = dw_conv(g, w0, b0)
    # cuDNN runs this dilated depthwise conv about 5x faster in NCHW than
    # in channels_last on an H100, even counting both layout copies
    # (PERF.md); the result goes back to channels_last for the 1x1 convs
    d7 = dw_conv(d5.contiguous(), ws, bs, dilation=3) \
        .contiguous(memory_format=torch.channels_last)
    c1 = mix(d7, wc1, bc1)
    p2 = mix(g * c1, wp2, bp2)
    return (p2 + x).permute(0, 2, 3, 1)


def van_attn_reference(x, a1, b1, wp1, bp1, w0, b0, ws, bs, wc1, bc1, wp2,
                       bp2, ls1):
    """Plain version of the fused half-block: bn1 affine (f32, rounded
    to x's dtype) + ``sa_core`` + layer scale + the block's residual."""
    h = (x.float() * a1.float() + b1.float()).to(x.dtype)
    sa = sa_core(h, wp1, bp1, w0, b0, ws, bs, wc1, bc1, wp2, bp2)
    return x + ls1.to(x.dtype) * sa


def van_attn_cuda(x, a1, b1, wp1, bp1, w0, b0, ws, bs, wc1, bc1, wp2, bp2,
                  ls1):
    """Launch the fused half-block on CUDA tensors: x [N, H, W, C]
    contiguous, f32 or bf16; a1, b1 [C] f32; the weights in x's dtype as
    ``nn.Conv2d`` holds them (1x1 ``[C, C, 1, 1]``, depthwise
    ``[C, 1, k, k]``); biases and ls1 ``[C]`` in x's dtype. One count
    per half-block (four kernel launches). Refuses inputs that require a
    gradient: autograd does not see the launches."""
    if x.dim() != 4:
        raise ValueError(f"van_attn: x {tuple(x.shape)} is not [N, H, W, C]")
    c = x.shape[3]
    f32 = {"a1": (a1, (c,)), "b1": (b1, (c,))}
    same = {"x": (x, tuple(x.shape)), "wp1": (wp1, (c, c, 1, 1)),
            "bp1": (bp1, (c,)), "w0": (w0, (c, 1, 5, 5)), "b0": (b0, (c,)),
            "ws": (ws, (c, 1, 7, 7)), "bs": (bs, (c,)),
            "wc1": (wc1, (c, c, 1, 1)), "bc1": (bc1, (c,)),
            "wp2": (wp2, (c, c, 1, 1)), "bp2": (bp2, (c,)),
            "ls1": (ls1, (c,))}
    tensors = {**f32, **same}
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t, _ in tensors.values()):
        raise RuntimeError("van_attn_cuda: an input requires a gradient; the "
                           "fused half-block is inference-only, train with "
                           "sa_core")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"van_attn kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    for name, (t, shape) in tensors.items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"van_attn: {name} is on {t.device}, x on "
                             f"{x.device}")
        want = torch.float32 if name in f32 else x.dtype
        if t.dtype != want:
            raise TypeError(f"van_attn: {name} is {t.dtype}, expected {want}")
        if tuple(t.shape) != shape:
            raise ValueError(f"van_attn: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"van_attn: {name} must be contiguous")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (x, wp1, wc1, wp2)):
        raise ValueError("van_attn: bf16 tensors must be 16-byte aligned")
    code = _DTYPE_CODE[x.dtype]
    lib = kernel_library()
    smem = lib.rs_van_attn_smem_bytes(c, code)
    limit = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    if smem == 0 or smem > limit:
        raise ValueError(f"van_attn kernel does not take C={c} in {x.dtype} "
                         f"(needs {smem} B of shared memory, limit {limit})")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    g = torch.empty_like(x)
    pixels = x.numel() // c
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        van_attn_cuda.launches += 1
        err = lib.rs_van_attn_proj1(
            x.data_ptr(), a1.data_ptr(), b1.data_ptr(), wp1.data_ptr(),
            bp1.data_ptr(), g.data_ptr(), pixels, c, code, stream)
        if err != 0:
            raise RuntimeError(f"van_attn proj1 launch failed: CUDA error "
                               f"{err}")
        d5 = depthwise_conv2d_cuda(g, w0, 5, 1, bias=b0, taps_last=True)
        d7 = depthwise_conv2d_cuda(d5, ws, 7, 3, bias=bs, taps_last=True)
        err = lib.rs_van_attn_tail(
            x.data_ptr(), a1.data_ptr(), b1.data_ptr(), g.data_ptr(),
            d7.data_ptr(), wc1.data_ptr(), bc1.data_ptr(), wp2.data_ptr(),
            bp2.data_ptr(), ls1.data_ptr(), out.data_ptr(), pixels, c, code,
            stream)
    if err != 0:
        raise RuntimeError(f"van_attn tail launch failed: CUDA error {err}")
    return out


van_attn_cuda.launches = 0


def van_attn(x, a1, b1, wp1, bp1, w0, b0, ws, bs, wc1, bc1, wp2, bp2, ls1):
    """Fused attention half-block, NHWC in and out: the kernels for a
    CUDA ``x``, the plain version for a CPU ``x``."""
    args = (x, a1, b1, wp1, bp1, w0, b0, ws, bs, wc1, bc1, wp2, bp2, ls1)
    if x.is_cuda:
        return van_attn_cuda(*args)
    if x.device.type == "cpu":
        return van_attn_reference(*args)
    raise ValueError(f"van_attn: no implementation for device {x.device}")
