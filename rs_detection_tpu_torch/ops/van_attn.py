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
multiply-add in ``csrc/``: ``proj1`` (affine, proj_1, GELU), the 5x5 and
the dilated 7x7 depthwise convs with their biases
(``csrc/dw_conv_fwd.cu`` through ``depthwise_conv2d_cuda``) and ``tail``
(conv1, the gate, proj_2, ``+ h``, layer scale, ``+ x``). ``proj1`` and
``tail`` have two designs, picked by the launcher in
``csrc/van_attn.cu`` and mirrored by ``attn_plan``: the wgmma design of
``csrc/van_attn_wgmma.cu`` for bf16 at VAN's widths, the first design
(``csrc/van_attn.cu``) for every other shape. On a CPU tensor it runs
``van_attn_reference``, the JAX ``_ref_attn``.
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
H100_SMEM = 232448         # the largest dynamic shared memory of one block
H100_SMEM_PER_SM = 233472  # shared memory of one SM
WGMMA_WIDTHS = (64, 128, 256, 320, 512)


def _up128(v):
    return (v + 127) // 128 * 128


def attn_plan(c, dtype, smem_limit=H100_SMEM, smem_per_sm=H100_SMEM_PER_SM):
    """How ``rs_van_attn_proj1`` / ``rs_van_attn_tail`` run a half-block
    of width ``c``, mirrored from the launchers in ``csrc/van_attn.cu``
    and ``csrc/van_attn_wgmma.cu``: the design (``"wgmma"``: bf16 at C in
    ``WGMMA_WIDTHS``; ``"wmma"``: every other bf16 width that is a
    multiple of 32; ``"fma"``: f32) and, per stage, the pixels one block
    owns, the output channels of a weight slab and the shared memory, and the bytes of scratch (the wgmma design's repacked
    weights). Raises ``ValueError`` for a width no kernel takes."""
    if dtype not in _DTYPE_CODE or c <= 0 or (dtype == torch.bfloat16
                                              and c % 32):
        raise ValueError(f"van_attn kernel does not take C={c} in {dtype} "
                         f"(bf16 widths: multiples of 32)")
    if dtype == torch.bfloat16 and c in WGMMA_WIDTHS:
        # per stage: slab width, warpgroups of 64 pixels, ring buffers,
        # activation tiles, staging tiles per warpgroup
        stages = {
            "proj1": (64 if c <= 320 else 32, 2,
                      1 if c == 64 else 3 if c == 256 else 2, 1,
                      1 if c == 64 else 2),
            "tail": (64 if c <= 256 else 32, 1 if c == 512 else 2,
                     2 if c <= 128 else 3, 2, 0)}

        def total(ns, wgs, nbuf, tiles, staged):
            return (tiles * wgs * 64 * c * 2 + nbuf * ns * c * 2
                    + staged * wgs * 64 * (ns * 2 + 16) + nbuf * 8 + 1024)

        return dict(design="wgmma",
                    slab={k: v[0] for k, v in stages.items()},
                    pixels={k: 64 * v[1] for k, v in stages.items()},
                    smem={k: total(*v) for k, v in stages.items()},
                    scratch=3 * c * c * 2)
    size = 2 if dtype == torch.bfloat16 else 4
    m, ld = (64, c + 8) if size == 2 else (32, c + 1)

    def total(tiles, nbuf):
        return (tiles * _up128(m * ld * size) + nbuf * _up128(32 * ld * size)
                + (8 * 256 * 4 if size == 2 else 0))

    def pick(tiles):  # the staging buffers that let most blocks share an SM
        def blocks(nbuf):
            need = total(tiles, nbuf)
            return smem_per_sm // (need + 1024) if need <= smem_limit else 0
        return total(tiles, 2 if blocks(2) >= blocks(1) else 1)

    return dict(design="wmma" if size == 2 else "fma",
                slab={"proj1": 32, "tail": 32}, pixels={"proj1": m, "tail": m},
                smem={"proj1": pick(1), "tail": pick(2)}, scratch=0)


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
                                         for t, _ in tensors.values()):
        raise ValueError("van_attn: bf16 tensors must be 16-byte aligned")
    code = _DTYPE_CODE[x.dtype]
    props = torch.cuda.get_device_properties(x.device)
    limit = props.shared_memory_per_block_optin
    plan = attn_plan(c, x.dtype, limit, props.shared_memory_per_multiprocessor)
    smem = max(plan["smem"].values())
    if smem > limit:
        raise ValueError(f"van_attn kernel does not take C={c} in {x.dtype} "
                         f"(needs {smem} B of shared memory, limit {limit})")
    lib = kernel_library()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    g = torch.empty_like(x)
    # the wgmma design repacks the three 1x1 weights into scratch
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=x.device)
    pixels = x.numel() // c
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        van_attn_cuda.launches += 1
        err = lib.rs_van_attn_proj1(
            x.data_ptr(), a1.data_ptr(), b1.data_ptr(), wp1.data_ptr(),
            bp1.data_ptr(), g.data_ptr(), scratch.data_ptr(), pixels, c, code,
            stream)
        if err != 0:
            raise RuntimeError(f"van_attn proj1 launch failed: CUDA error "
                               f"{err}")
        d5 = depthwise_conv2d_cuda(g, w0, 5, 1, bias=b0, taps_last=True)
        d7 = depthwise_conv2d_cuda(d5, ws, 7, 3, bias=bs, taps_last=True)
        err = lib.rs_van_attn_tail(
            x.data_ptr(), a1.data_ptr(), b1.data_ptr(), g.data_ptr(),
            d7.data_ptr(), wc1.data_ptr(), bc1.data_ptr(), wp2.data_ptr(),
            bp2.data_ptr(), ls1.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            pixels, c, code, stream)
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
