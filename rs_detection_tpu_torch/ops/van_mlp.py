"""VAN MLP: fc1 (1x1) -> depthwise 3x3 -> erf GELU -> fc2 (1x1).

Counterpart of ``rs_detection_tpu/ops/pallas_van_mlp.py``. On a CUDA
tensor ``van_mlp`` launches the fused kernel (``csrc/van_mlp.cu``, whose
launcher picks the wgmma design of ``csrc/van_mlp_wgmma.cu`` for bf16 at
VAN's widths; ``kernel_plan`` says which shape runs what), which keeps
the 4-8x wide hidden tensor out of device memory; on a CPU tensor
it runs ``van_mlp_reference``, the plain composition (the JAX
``_ref_mlp``). ``van_mlp_residual`` is the same kernel with its residual
flag set: ``x + mlp(x)`` with the add in f32 inside the kernel, the form
the fused VAN block calls with bn2 and the layer scale folded into the
weights (the JAX ``van_mlp_residual``).

``van_mlp_int8`` and ``van_mlp_residual_int8`` are the int8 serving
forms (``ops/quant.py``; the ``quant=True`` form of the TPU kernel): both
1x1 products run s8 x s8 -> s32 on weights quantized per output channel
and activations quantized dynamically, the depthwise conv and the GELU
stay in float. They take the same float arguments; the weights are
quantized on every call (on the card by a small kernel that equals
``qweight`` bit for bit; ``pack_int8_weights`` is its Python version).
What differs between the three users of this
arithmetic is the group over which an activation scale ``max|v| / 127``
is taken, so the plain version ``van_mlp_int8_reference`` takes the
group as an argument:

* ``"tile"``, the CUDA kernels' (``csrc/van_mlp_int8.cu`` and its wgmma
  design ``csrc/van_mlp_int8_wgmma.cu``) and the default:
  fc1 one scale per 8x8 output tile over its haloed 10x10 x patch, fc2
  one scale per (tile, 32-channel hidden chunk) over the f32 GELU
  output. The kernel walks the hidden channels in chunks and never holds
  a tile's whole hidden tensor, so a scale per chunk keeps it one pass;
* ``("rows", bh)``, the TPU kernel's: fc1 one scale per haloed block of
  ``bh + 2`` rows, fc2 one per ``bh x W`` block over all hidden
  channels (rows past H, which the TPU kernel lets into the scale, are
  left out here: compare at H a multiple of ``bh``);
* ``"tensor"``, the JAX package's XLA composition ``_int8_mlp``, which
  it runs wherever it does not run its kernel: ``int8_channel_matmul``
  twice, one scale per tensor, a divide where the kernels multiply by
  the reciprocal, and the GELU output rounded to the input dtype first.

Every group is a finer one than the next; all are within the int8
mode's error of the float MLP.

Layouts: ``x`` is NHWC ``[N, H, W, C]``; the weights are as
``nn.Conv2d`` holds them, squeezed: ``w1 [Ch, C]``, ``wdw [Ch, 9]``
(3x3 taps row-major), ``w2 [C, Ch]``; biases ``b1 [Ch]``, ``bdw [Ch]``,
``b2 [C]``.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from ._build import kernel_library
from .activations import exact_gelu
from .dw_conv import dw_conv
from .quant import int8_channel_matmul, int_matmul, qweight, scale_of

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 8    # side of the CUDA kernel's output tile
CHUNK = 32  # hidden channels the CUDA kernel holds at a time


def van_mlp_reference(x, w1, b1, wdw, bdw, w2, b2):
    """Plain PyTorch composition; SAME zero padding on the hidden
    tensor, as the reference's nn.Conv2d chain. Differentiable: the
    depthwise conv is ``dw_conv``, whose weight gradient is K6 on CUDA
    (the JAX ``_ref_mlp`` under ``RS_DW_TAP_BWD=1``)."""
    ch = w1.shape[0]
    h = torch.matmul(x, w1.t()) + b1
    h = dw_conv(h.permute(0, 3, 1, 2), wdw.reshape(ch, 1, 3, 3), bdw)
    h = exact_gelu(h).permute(0, 2, 3, 1)
    return torch.matmul(h, w2.t()) + b2


def van_mlp_residual_reference(x, w1, b1, wdw, bdw, w2, b2):
    """Plain version of ``x + mlp(x)``: the sum in f32, one cast to the
    input dtype, as the kernel."""
    y = van_mlp_reference(x, w1, b1, wdw, bdw, w2, b2)
    return (x.float() + y.float()).to(x.dtype)


def _qblock(t):
    """Per-block dynamic quantization as the kernels do it: one scale
    over all of ``t [B, ...]`` but its first dimension, multiplied in as
    a reciprocal. Returns (int8, scale ``[B, 1, ...]``)."""
    amax = t.abs().amax(dim=tuple(range(1, t.dim())), keepdim=True)
    scale = scale_of(amax)
    q = torch.clamp(torch.round(t * (1.0 / scale)), -127, 127)
    return q.to(torch.int8), scale


def _int8_mlp_blocked(x, w1, b1, wdw, bdw, w2, b2, bh, bw, chunk, residual):
    """The kernels' int8 MLP on blocks of ``bh x bw`` output pixels with
    their one-pixel halo, the hidden channels ``chunk`` at a time. A
    halo pixel is quantized with the scale of the block that reads it,
    so the hidden tensor is not globally defined: the blocks are
    unfolded, halos and all, and folded back at the end."""
    n, h, w, c = x.shape
    ch = w1.shape[0]
    bh, bw = min(bh, h), min(bw, w)
    nby, nbx = -(-h // bh), -(-w // bw)
    hp, wp = nby * bh, nbx * bw
    w1q, sw1 = qweight(w1, 0)
    w2q, sw2 = qweight(w2, 0)

    def unfold(t):  # [.., hp+2, wp+2, k] -> [.., nby, nbx, bh+2, bw+2, k]
        return t.unfold(-3, bh + 2, bh).unfold(-3, bw + 2, bw) \
            .movedim(-3, -1)

    xp = F.pad(x, (0, 0, 1, wp - w + 1, 1, hp - h + 1))
    xb = unfold(xp).reshape(-1, bh + 2, bw + 2, c).float()
    blocks = xb.shape[0]
    inside = torch.zeros(hp + 2, wp + 2, 1, dtype=torch.bool, device=x.device)
    inside[1:h + 1, 1:w + 1] = True
    inside = unfold(inside).expand(n, -1, -1, -1, -1, -1) \
        .reshape(blocks, bh + 2, bw + 2, 1)

    # fc1 of the haloed block, one scale per block (zeros outside the
    # image take no part in a maximum)
    xq, sx = _qblock(xb)
    acc = int_matmul(xq.view(-1, c), w1q.t()).view(blocks, bh + 2, bw + 2, ch)
    h1 = (acc.float() * (sx * sw1) + b1.float()).to(x.dtype)
    h1 = torch.where(inside, h1, 0).float()   # SAME padding of the hidden

    # depthwise 3x3 and erf GELU in f32, not rounded
    taps = wdw.float()
    pre = None
    for dx in range(3):
        for dy in range(3):
            tap = h1[:, dy:dy + bh, dx:dx + bw] * taps[:, dy * 3 + dx]
            pre = tap if pre is None else pre + tap
    g = exact_gelu(pre + bdw.float())
    g = torch.where(inside[:, 1:-1, 1:-1], g, 0)

    # fc2, one scale per (block, chunk); sw2 does not depend on the chunk
    y = torch.zeros(blocks, bh * bw, c, device=x.device)
    for k0 in range(0, ch, chunk):
        gq, sg = _qblock(g[..., k0:k0 + chunk])
        part = int_matmul(gq.view(-1, gq.shape[-1]), w2q[:, k0:k0 + chunk].t())
        y = y + sg.view(blocks, 1, 1) * part.view(blocks, bh * bw, c).float()
    y = y * sw2 + b2.float()
    y = y.view(n, nby, nbx, bh, bw, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, hp, wp, c)[:, :h, :w]
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


def _int8_mlp(x, w1, b1, wdw, bdw, w2, b2, group, residual):
    if group == "tensor":
        ch = w1.shape[0]
        hid = int8_channel_matmul(x, w1, b1)
        hid = dw_conv(hid.permute(0, 3, 1, 2), wdw.reshape(ch, 1, 3, 3), bdw)
        hid = exact_gelu(hid).permute(0, 2, 3, 1)
        y = int8_channel_matmul(hid, w2, b2)
        return (x.float() + y.float()).to(x.dtype) if residual else y
    if group == "tile":
        bh, bw, chunk = TILE, TILE, CHUNK
    elif isinstance(group, tuple) and len(group) == 2 and group[0] == "rows":
        bh, bw, chunk = int(group[1]), x.shape[2], w1.shape[0]
    else:
        raise ValueError(f"van_mlp_int8: group {group!r} is not 'tile', "
                         f"'tensor' or ('rows', bh)")
    return _int8_mlp_blocked(x, w1, b1, wdw, bdw, w2, b2, bh, bw, chunk,
                             residual)


def van_mlp_int8_reference(x, w1, b1, wdw, bdw, w2, b2, group="tile"):
    """Plain version of the int8 MLP with the activation scales taken
    over ``group`` (module docstring): ``"tile"`` repeats the CUDA
    kernel, ``("rows", bh)`` the TPU kernel, ``"tensor"`` the JAX
    ``_int8_mlp``. Inference only."""
    return _int8_mlp(x, w1, b1, wdw, bdw, w2, b2, group, False)


def van_mlp_residual_int8_reference(x, w1, b1, wdw, bdw, w2, b2,
                                    group="tile"):
    """Plain version of the int8 ``x + mlp(x)``; in the blocked groups
    the sum is made in f32 before the one cast, as in the kernels."""
    return _int8_mlp(x, w1, b1, wdw, bdw, w2, b2, group, True)


H100_SMEM = 232448  # the largest dynamic shared memory of one block
BF16_WIDTHS = (32, 64, 128, 256, 320, 512)
WGMMA_WIDTHS = (64, 128, 256, 320, 512)


def _up128(v):
    return (v + 127) // 128 * 128


def kernel_plan(c, ch, dtype, smem_limit=H100_SMEM, int8=False):
    """How ``rs_van_mlp_fwd`` (with ``int8``: ``rs_van_mlp_int8_fwd``)
    runs an MLP of these widths, mirrored from the launchers in
    ``csrc/van_mlp.cu`` / ``csrc/van_mlp_wgmma.cu`` and
    ``csrc/van_mlp_int8.cu`` / ``csrc/van_mlp_int8_wgmma.cu``: the design
    the shape picks (``"wgmma"``: bf16 at C in ``WGMMA_WIDTHS`` and, in
    float, Ch a multiple of 8; ``"wmma"``: every other bf16 shape;
    ``"fma"``: f32, integer multiply-adds in the int8 form), the hidden
    channels it holds at a time, one block's shared memory and the bytes
    of scratch (the wgmma designs' repacked weights; in the int8 form
    always the quantized weights and their scales). Raises
    ``ValueError`` for a width no kernel takes."""
    if dtype == torch.bfloat16 and c not in BF16_WIDTHS or c <= 0 or ch <= 0:
        raise ValueError(f"van_mlp kernel does not take C={c}, Ch={ch} in "
                         f"{dtype} (bf16 widths: {BF16_WIDTHS})")
    if int8:
        return _int8_plan(c, ch, dtype, smem_limit)
    if dtype == torch.bfloat16 and c in WGMMA_WIDTHS and ch % 8 == 0:
        kc = 32 if c == 512 else 64
        kb, w2_buffers = c // 64, 2 if c == 64 else 1
        w1_chunk, w2_chunk, taps = kb * kc * 128, c * kc * 2, kc * 22
        smem = (kb * 104 * 128 + 2 * w1_chunk + w2_buffers * w2_chunk
                + 64 * kc * 2 + _up128(100 * (kc * 2 + 16)) + 3 * taps
                + 4 * 8 + 1024)
        return dict(design="wgmma", chunk=kc, smem=smem,
                    scratch=-(-ch // kc) * (w1_chunk + taps + w2_chunk))
    size = 2 if dtype == torch.bfloat16 else 4
    ld_x, ld_w2 = (c + 8, 40) if size == 2 else (c + 1, 33)

    def total(nbuf):
        staged = (_up128(32 * ld_x * size) + _up128(c * ld_w2 * size)
                  + _up128(32 * 11 * size))
        extra = 8 * 256 * 4 if size == 2 else 64 * c * 4
        return (_up128(112 * ld_x * size) + nbuf * staged
                + _up128(112 * 36 * 4) + _up128(64 * 40 * size)
                + _up128(extra))

    smem = total(2) if total(2) <= smem_limit else total(1)
    return dict(design="wmma" if size == 2 else "fma", chunk=CHUNK,
                smem=smem, scratch=0)


def int8_round(c):
    """Hidden channels the int8 wgmma design holds at a time: two scale
    chunks, one at C = 512."""
    return CHUNK if c == 512 else 2 * CHUNK


def _int8_packed(c):
    """Byte offsets inside one round of the int8 wgmma design's packed
    weights: (b1 | bdw | taps | sw1, w2, the round's size); w1 is at 0."""
    kc = int8_round(c)
    vs = kc * c
    w2 = vs + kc * 26
    return vs, w2, w2 + c * kc


def _int8_plan(c, ch, dtype, smem_limit):
    if dtype == torch.bfloat16 and c in WGMMA_WIDTHS:
        kc = int8_round(c)
        w2_buffers = 2 if c == 64 else 1
        smem = ((c // 64) * 104 * 64 + 2 * kc * c + w2_buffers * c * kc
                + 64 * kc + _up128(100 * (kc * 2 + 16)) + 3 * kc * 26
                + 8 * 2 * 4 + 4 * 8 + 1024)
        return dict(design="wgmma", chunk=kc, smem=smem,
                    scratch=-(-ch // kc) * _int8_packed(c)[2] + 4 * c)
    size = 2 if dtype == torch.bfloat16 else 4
    ld_q = -(-c // 16) * 16 + 16

    def total(nbuf):
        staged = (_up128(32 * ld_q) + _up128(c * 48) + _up128(32 * 11 * size)
                  + _up128(32 * 4))
        extra = 8 * 256 * 4 if size == 2 else 64 * c * 4
        return (_up128(112 * ld_q) + nbuf * staged + _up128(112 * 36 * 4)
                + _up128(64 * 48) + _up128(8 * 4) + _up128(extra))

    smem = total(2) if total(2) <= smem_limit else total(1)
    up16 = -(-c * ch // 16) * 16
    return dict(design="wmma" if size == 2 else "fma", chunk=CHUNK,
                smem=smem,
                scratch=2 * up16 + -(-4 * ch // 16) * 16 + 4 * c)


def _int8_pack_offsets(c, ch, device):
    """Where the int8 wgmma design keeps each weight byte: byte offsets
    of w1q ``[nk * kc, C]`` and w2q ``[C, nk * kc]`` (padded to whole
    rounds) in the packed buffer, mirrored from ``van_mlp_q_pack_kernel``.
    w1 rows are 64-byte swizzled rows of 64 input channels (16-byte
    vector j of row r at ``j ^ (r // 2) % 4``); w2 rows hold a round's
    hidden channels, 64-byte swizzled, or 32-byte swizzled at C = 512
    (``j ^ (r // 4) % 2``)."""
    kc = int8_round(c)
    nk = -(-ch // kc)
    _, p_w2, total = _int8_packed(c)
    h = torch.arange(nk * kc, device=device)
    k, r = h // kc, h % kc
    i = torch.arange(c, device=device)
    w1 = ((k * total + r * 64)[:, None] + ((i >> 6) * (kc * 64))[None]
          + ((((i & 63) >> 4)[None] ^ (r >> 1)[:, None]) & 3) * 16
          + (i & 15)[None])
    o = torch.arange(c, device=device)
    shift, mask = (1, 3) if kc == 64 else (2, 1)
    w2 = ((k * total + p_w2 + (r & 15))[None] + (o * kc)[:, None]
          + (((r >> 4)[None] ^ (o >> shift)[:, None]) & mask) * 16)
    return w1, w2


def pack_int8_weights(w1, b1, wdw, bdw, w2):
    """Python version of the weight preparation of the int8 wgmma design
    (``van_mlp_q_pack_kernel``): ``qweight`` per output channel, then the
    bytes as the kernel's shared memory wants them, per round of hidden
    channels w1 | b1, bdw, taps (bf16), sw1 (f32) | w2, zero past Ch, and
    sw2 (f32) after the last round. bf16 weights at C in
    ``WGMMA_WIDTHS``; returns a uint8 tensor of
    ``kernel_plan(..., int8=True)["scratch"]`` bytes."""
    ch, c = w1.shape
    if w1.dtype != torch.bfloat16 or c not in WGMMA_WIDTHS:
        raise ValueError(f"pack_int8_weights: bf16 at C in {WGMMA_WIDTHS}, "
                         f"not {w1.dtype} at C={c}")
    kc = int8_round(c)
    nk = -(-ch // kc)
    p_vs, _, total = _int8_packed(c)
    dev = w1.device
    buf = torch.zeros(nk * total + 4 * c, dtype=torch.uint8, device=dev)
    (w1q, sw1), (w2q, sw2) = qweight(w1, 0), qweight(w2, 0)
    at1, at2 = _int8_pack_offsets(c, ch, dev)
    buf[at1[:ch].reshape(-1)] = w1q.view(torch.uint8).reshape(-1)
    buf[at2[:, :ch].reshape(-1)] = w2q.view(torch.uint8).reshape(-1)

    def put(at, values):  # values [n, ...] at byte offsets at [n]
        raw = values.contiguous().view(torch.uint8).reshape(len(at), -1)
        idx = at[:, None] + torch.arange(raw.shape[1], device=dev)[None]
        buf[idx.reshape(-1)] = raw.reshape(-1)

    h = torch.arange(nk * kc, device=dev)
    base = (h // kc) * total + p_vs
    r = h % kc
    put((base + r * 2)[:ch], b1)
    put((base + kc * 2 + r * 2)[:ch], bdw)
    put((base + kc * 4 + r * 18)[:ch], wdw)
    pad = torch.ones(nk * kc, device=dev)
    pad[:ch] = sw1
    put(base + kc * 22 + r * 4, pad)
    put(nk * total + 4 * torch.arange(c, device=dev), sw2)
    return buf


def unpack_int8_weights(buf, c, ch):
    """``(w1q [Ch, C] int8, sw1 [Ch], w2q [C, Ch] int8, sw2 [C])`` read
    back from a buffer of ``pack_int8_weights``' layout."""
    kc = int8_round(c)
    nk = -(-ch // kc)
    p_vs, _, total = _int8_packed(c)
    at1, at2 = _int8_pack_offsets(c, ch, buf.device)
    w1q = buf[at1[:ch]].view(torch.int8)
    w2q = buf[at2[:, :ch]].view(torch.int8)
    h = torch.arange(ch, device=buf.device)
    four = torch.arange(4, device=buf.device)
    at = (h // kc) * total + p_vs + kc * 22 + (h % kc) * 4
    sw1 = buf[at[:, None] + four].contiguous().view(torch.float32).view(-1)
    sw2 = buf[nk * total:nk * total + 4 * c].contiguous() \
        .view(torch.float32).view(-1)
    return w1q, sw1, w2q, sw2


def _launch(wrapper, name, args, residual, int8=False):
    """Check the operands and launch ``rs_van_mlp_fwd`` (with ``int8``:
    ``rs_van_mlp_int8_fwd``, which first quantizes w1 and w2 per output
    channel into the scratch), counting the launch on ``wrapper``. Raises
    when grad mode is on and an input requires a gradient: the kernel
    has no backward, and autograd does not see the launch, so its result
    would be cut off from the graph (training runs
    ``van_mlp_reference``)."""
    x, w1 = args[:2]
    n, h, w, c = x.shape
    ch = w1.shape[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(f"{name}_cuda: an input requires a gradient; the "
                           f"fused kernel is inference-only, train with "
                           f"van_mlp_reference")
    shapes = ((n, h, w, c), (ch, c), (ch,), (ch, 9), (ch,), (c, ch), (c,))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    for label, t, shape in zip(("x", "w1", "b1", "wdw", "bdw", "w2", "b2"),
                               args, shapes):
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"{name}: {label} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, x is {x.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in args):
        raise ValueError(f"{name}: bf16 tensors must be 16-byte aligned")
    code = _DTYPE_CODE[x.dtype]
    limit = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    plan = kernel_plan(c, ch, x.dtype, limit, int8=int8)
    if plan["smem"] > limit:
        raise ValueError(f"{name} kernel does not take C={c} in {x.dtype} "
                         f"(needs {plan['smem']} B of shared memory, limit "
                         f"{limit})")
    lib = kernel_library()
    fwd = lib.rs_van_mlp_int8_fwd if int8 else lib.rs_van_mlp_fwd
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    # the wgmma designs repack the weights into scratch, the int8 form
    # quantizes them there
    scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        wrapper.launches += 1
        err = fwd(*(t.data_ptr() for t in args), y.data_ptr(),
                  scratch.data_ptr(), n, h, w, c, ch, code, int(residual),
                  stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return y


def van_mlp_cuda(x, w1, b1, wdw, bdw, w2, b2):
    """Launch the fused kernel on CUDA tensors (f32 or bf16); refuses
    inputs that require a gradient."""
    return _launch(van_mlp_cuda, "van_mlp", (x, w1, b1, wdw, bdw, w2, b2),
                   False)


van_mlp_cuda.launches = 0


def van_mlp_residual_cuda(x, w1, b1, wdw, bdw, w2, b2):
    """Launch the kernel's residual form, ``x + mlp(x)``, on CUDA tensors;
    its launches count apart from ``van_mlp_cuda``'s."""
    return _launch(van_mlp_residual_cuda, "van_mlp_residual",
                   (x, w1, b1, wdw, bdw, w2, b2), True)


van_mlp_residual_cuda.launches = 0


def van_mlp(x, w1, b1, wdw, bdw, w2, b2):
    """Fused VAN MLP: the kernel for a CUDA ``x``, the plain version for
    a CPU ``x``."""
    if x.is_cuda:
        return van_mlp_cuda(x, w1, b1, wdw, bdw, w2, b2)
    if x.device.type == "cpu":
        return van_mlp_reference(x, w1, b1, wdw, bdw, w2, b2)
    raise ValueError(f"van_mlp: no implementation for device {x.device}")


def van_mlp_residual(x, w1, b1, wdw, bdw, w2, b2):
    """Inference-only fused ``x + mlp(x)``: the kernel for a CUDA ``x``,
    the plain version for a CPU ``x``."""
    if x.is_cuda:
        return van_mlp_residual_cuda(x, w1, b1, wdw, bdw, w2, b2)
    if x.device.type == "cpu":
        return van_mlp_residual_reference(x, w1, b1, wdw, bdw, w2, b2)
    raise ValueError(f"van_mlp_residual: no implementation for device "
                     f"{x.device}")


def van_mlp_int8_cuda(x, w1, b1, wdw, bdw, w2, b2):
    """Launch the kernel's int8 form on CUDA tensors (f32 or bf16; w1
    and w2 are quantized here, per output channel); refuses inputs that
    require a gradient."""
    return _launch(van_mlp_int8_cuda, "van_mlp_int8",
                   (x, w1, b1, wdw, bdw, w2, b2), False, int8=True)


van_mlp_int8_cuda.launches = 0


def van_mlp_residual_int8_cuda(x, w1, b1, wdw, bdw, w2, b2):
    """Launch the int8 form with the residual flag, ``x + mlp(x)``; its
    launches count apart."""
    return _launch(van_mlp_residual_int8_cuda, "van_mlp_residual_int8",
                   (x, w1, b1, wdw, bdw, w2, b2), True, int8=True)


van_mlp_residual_int8_cuda.launches = 0


def _dispatch_int8(name, cuda_fn, reference, args, group):
    x = args[0]
    if x.is_cuda:
        if group != "tile":
            raise ValueError(f"{name}: the CUDA kernel has the 'tile' group "
                             f"only, not {group!r}")
        return cuda_fn(*args)
    if x.device.type == "cpu":
        return reference(*args, group=group)
    raise ValueError(f"{name}: no implementation for device {x.device}")


def van_mlp_int8(x, w1, b1, wdw, bdw, w2, b2, group="tile"):
    """int8 serving form of the fused VAN MLP: the kernel for a CUDA
    ``x``, the plain version for a CPU ``x``. ``group`` other than the
    kernel's is for the CPU only (the tests hold the port against the
    JAX package's groupings with it)."""
    return _dispatch_int8("van_mlp_int8", van_mlp_int8_cuda,
                          van_mlp_int8_reference,
                          (x, w1, b1, wdw, bdw, w2, b2), group)


def van_mlp_residual_int8(x, w1, b1, wdw, bdw, w2, b2, group="tile"):
    """int8 serving form of the fused ``x + mlp(x)``."""
    return _dispatch_int8("van_mlp_residual_int8",
                          van_mlp_residual_int8_cuda,
                          van_mlp_residual_int8_reference,
                          (x, w1, b1, wdw, bdw, w2, b2), group)
