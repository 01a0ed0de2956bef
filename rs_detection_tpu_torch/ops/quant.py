"""int8 serving mode (counterpart of ``rs_detection_tpu/ops/quant.py``).

Opt-in by constructor flag (``VAN(int8=True)``, ``FPN(int8=True)``,
``OrientedRPNHead(int8=True)``, ``build_flagship(int8=True)``), serving
only: training ignores it. Behind the flag the dense channel-mixing
products run as s8 x s8 -> s32:

* activations: dynamic symmetric per-tensor int8, ``scale = max|x| / 127``
  taken on the fly (1 for the zero tensor), round half to even;
* weights: symmetric int8 per output channel;
* sums in int32, exact on every device; dequantization and bias in f32,
  one cast to the caller's dtype.

Depthwise convs, GELU, box decode and NMS stay in the input dtype. The
callers are the three 1x1 mixes of ``ops.van_attn.sa_core``, the VAN MLP
(``ops.van_mlp``, whose fused kernel has its own int8 form), the
patch-embed convs of stages 2-4, the FPN lateral and output convs and the
RPN tower conv (``models.utils.modules.maybe_int8_conv2d``).

Layouts are the port's: weights as ``nn.Conv2d`` holds them
(``[out, in]`` for a channel mix, ``[out, in, kh, kw]`` for a conv),
output channel first; ``int8_conv`` takes and returns NCHW.

The integer products go to ``torch._int_mm`` (the JAX package leaves
them to XLA, outside any kernel). On CUDA it wants more than 16 rows and
every extent a multiple of 8: ``int_matmul`` pads with zeros, which add
nothing to an integer sum. A float product would be exact only up to
``K * 127^2 < 2^24``, K <= 1040, and the 3x3 convs are past that. A conv
is one integer product over its unfolded windows. The scales stay
tensors on the device: reading one on the host would stall the stream
once per conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def scale_of(amax):
    """``amax / 127``, 1 where amax is 0. The divisor is a tensor beside
    amax: by a Python number PyTorch multiplies by the rounded reciprocal
    on CUDA and divides on the CPU, and the scales would differ in the
    last bit between the devices."""
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def qact(x):
    """Dynamic symmetric per-tensor quantization of activations:
    ``(x_q int8, scale f32 scalar tensor)`` with ``x ~= x_q * scale``."""
    xf = x.float()
    scale = scale_of(xf.abs().amax())
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def qweight(w, axis: int = 0):
    """Symmetric int8 weights with one scale per slice along ``axis``
    (the output channel): ``(w_q int8, scale f32 [w.shape[axis]])``."""
    wf = w.float()
    axis = axis % wf.dim()
    red = [i for i in range(wf.dim()) if i != axis]
    scale = scale_of(wf.abs().amax(dim=red, keepdim=True))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def int_matmul(a, b):
    """Exact ``a [M, K] int8 @ b [K, N] int8 -> [M, N] int32``."""
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros(m, n, dtype=torch.int32, device=a.device)
    if not a.is_cuda:
        return torch._int_mm(a.contiguous(), b.contiguous())
    # cuBLASLt's int8 product: more than 16 rows, every extent a multiple
    # of 8 (an M of 2046 is refused), a row-major and b column-major (its
    # tensor-core kernels take no other layout; [1800, 32] x [32, 96] with
    # b row-major is refused)
    mp, kp, np_ = max(-(-m // 8) * 8, 24), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def int_conv2d(xq, wq, stride=(1, 1), padding=(0, 0)):
    """Exact dense conv of int8 tensors: ``xq`` NHWC ``[N, H, W, Cin]``,
    ``wq`` ``[Cout, Cin, kh, kw]`` -> int32 NHWC ``[N, Ho, Wo, Cout]``.
    The shifted, strided windows of the taps side by side along the
    channels, then one integer product of depth ``kh * kw * Cin`` (on an
    H100 half the time of a product per tap summed in int32)."""
    n, h, w, cin = xq.shape
    cout, _, kh, kw = wq.shape
    sy, sx = stride
    py, px = padding
    ho = (h + 2 * py - kh) // sy + 1
    wo = (w + 2 * px - kw) // sx + 1
    xp = F.pad(xq, (0, 0, px, px, py, py)) if (py or px) else xq
    cols = torch.cat([xp[:, dy:dy + (ho - 1) * sy + 1:sy,
                         dx:dx + (wo - 1) * sx + 1:sx]
                      for dy in range(kh) for dx in range(kw)], dim=-1)
    wmat = wq.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    return int_matmul(cols.view(-1, kh * kw * cin), wmat.t()) \
        .view(n, ho, wo, cout)


def _dequant(acc, sx, sw, b, dtype):
    y = acc.float() * (sx * sw)
    if b is not None:
        y = y + b.float()
    return y.to(dtype)


def int8_channel_matmul(x, w, b=None):
    """``x [..., C] @ w [D, C]^T (+ b)`` with int8 inputs and an int32
    sum, in x's dtype."""
    xq, sx = qact(x)
    wq, sw = qweight(w, 0)
    acc = int_matmul(xq.reshape(-1, xq.shape[-1]), wq.t())
    return _dequant(acc, sx, sw, b, x.dtype).view(*x.shape[:-1], w.shape[0])


def int8_conv(x, w, b=None, stride=(1, 1), padding=(0, 0)):
    """Dense conv with int8 inputs and an int32 sum: ``x`` NCHW (any
    memory format; channels_last makes the NHWC view free), ``w``
    ``[Cout, Cin, kh, kw]``. Returns NCHW in channels_last memory, in
    x's dtype."""
    xq, sx = qact(x.permute(0, 2, 3, 1))
    wq, sw = qweight(w, 0)
    acc = int_conv2d(xq, wq, stride, padding)
    return _dequant(acc, sx, sw, b, x.dtype).permute(0, 3, 1, 2)
