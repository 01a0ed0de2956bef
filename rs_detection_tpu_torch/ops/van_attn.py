"""VAN spatial-attention body (counterpart of ``_sa_core`` in
``rs_detection_tpu/ops/pallas_van_attn.py``), plain PyTorch around
``dw_conv``, whose weight gradient is the K6 kernel on CUDA.

The JAX package also has a fused kernel for the whole attention
half-block (``_attn_kernel``); it is opt-in there and not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .activations import exact_gelu
from .dw_conv import dw_conv


def sa_core(h, wp1, bp1, w0, b0, ws, bs, wc1, bc1, wp2, bp2):
    """``proj_2(g * conv1(dw7d3(dw5(g)))) + h`` with
    ``g = gelu(proj_1(h))``, the module's inner shortcut included.

    ``h`` is NHWC ``[N, H, W, C]``; the weights are as ``nn.Conv2d``
    holds them: 1x1 ``[C, C, 1, 1]``, depthwise ``[C, 1, k, k]``.
    Returns NHWC (a view of a channels-last NCHW result)."""
    x = h.permute(0, 3, 1, 2)
    g = exact_gelu(F.conv2d(x, wp1, bp1))
    d5 = dw_conv(g, w0, b0)
    # cuDNN runs this dilated depthwise conv about 5x faster in NCHW than
    # in channels_last on an H100, even counting both layout copies
    # (PERF.md); the result goes back to channels_last for the 1x1 convs
    d7 = dw_conv(d5.contiguous(), ws, bs, dilation=3) \
        .contiguous(memory_format=torch.channels_last)
    c1 = F.conv2d(d7, wc1, bc1)
    p2 = F.conv2d(g * c1, wp2, bp2)
    return (p2 + x).permute(0, 2, 3, 1)
