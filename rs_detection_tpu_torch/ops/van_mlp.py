"""VAN MLP: fc1 (1x1) -> depthwise 3x3 -> erf GELU -> fc2 (1x1).

Counterpart of ``rs_detection_tpu/ops/pallas_van_mlp.py``. On a CUDA
tensor ``van_mlp`` launches the fused kernel ``csrc/van_mlp.cu``, which
keeps the 4-8x wide hidden tensor out of device memory; on a CPU tensor
it runs ``van_mlp_reference``, the plain composition (the JAX
``_ref_mlp``). ``van_mlp_residual`` is the same kernel with its residual
flag set: ``x + mlp(x)`` with the add in f32 inside the kernel, the form
the fused VAN block calls with bn2 and the layer scale folded into the
weights (the JAX ``van_mlp_residual``).

Layouts: ``x`` is NHWC ``[N, H, W, C]``; the weights are as
``nn.Conv2d`` holds them, squeezed: ``w1 [Ch, C]``, ``wdw [Ch, 9]``
(3x3 taps row-major), ``w2 [C, Ch]``; biases ``b1 [Ch]``, ``bdw [Ch]``,
``b2 [C]``.
"""

from __future__ import annotations

import torch

from ._build import kernel_library
from .activations import exact_gelu
from .dw_conv import dw_conv

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def _launch(wrapper, name, args, residual):
    """Check the operands and launch ``rs_van_mlp_fwd``, counting the
    launch on ``wrapper``. Raises when grad mode is on and an input
    requires a gradient: the kernel has no backward, and autograd does
    not see the launch, so its result would be cut off from the graph
    (training runs ``van_mlp_reference``)."""
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
    lib = kernel_library()
    smem = lib.rs_van_mlp_smem_bytes(c, code)
    limit = torch.cuda.get_device_properties(x.device) \
        .shared_memory_per_block_optin
    if smem == 0 or smem > limit:
        raise ValueError(f"{name} kernel does not take C={c} in {x.dtype} "
                         f"(needs {smem} B of shared memory, limit {limit})")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        wrapper.launches += 1
        err = lib.rs_van_mlp_fwd(*(t.data_ptr() for t in args), y.data_ptr(),
                                 n, h, w, c, ch, code, int(residual), stream)
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
