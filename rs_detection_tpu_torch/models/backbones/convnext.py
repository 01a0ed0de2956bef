"""ConvNeXt backbone family (counterpart of
``rs_detection_tpu/models/backbones/convnext.py``): depthwise 7x7, LN,
pointwise MLP (4x), layer scale ``gamma``, stochastic depth; stem 4x4/4,
LN + 2x2/2 downsample between stages, an LN on each returned stage;
``convnext_tiny`` .. ``convnext_xlarge``.

Public layout as in VAN: NHWC images in, a tuple of NHWC stage outputs
out. A block's state is NCHW in ``channels_last`` memory, which is the
contiguous NHWC the LayerNorm and the two ``Linear`` layers take. The
depthwise 7x7 runs through ``ops.dw_conv`` (cuDNN forward, K6 weight
gradient on CUDA) on an NCHW copy, as VAN's dilated conv does. At this
7x7 in f32 cuDNN measured faster in channels_last, and K5 faster still
(ROADMAP, Queue 2, recorded item 2): the layout is that item's to
change. Submodule names follow the flax tree (``Conv_0``, ``LayerNorm_0``,
``Dense_0``, ``Dense_1``, ``gamma`` per block; ``stem``, ``stem_norm``,
``down_norm{i}``, ``down{i}``, ``out_norm{i}``), so
``utils/jax_weights.py`` maps one onto the other by name.

The constructors drop ``in_22k`` and ``pretrained`` and pass every other
key on, as JAX's do: a config's ``frozen_stages`` or ``return_stages``
raises ``TypeError`` in both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...ops.activations import exact_gelu
from ...ops.dw_conv import dw_conv
from ...utils.registry import BACKBONES
from ..utils.modules import DropPath, conv2d, layer_norm, linear


def channel_norm(m: nn.LayerNorm, x):
    """``layer_norm`` over the channels of NCHW x (channels_last in and
    out)."""
    return layer_norm(m, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):

    def __init__(self, dim: int, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6):
        super().__init__()
        self.Conv_0 = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.Dense_0 = nn.Linear(dim, 4 * dim)
        self.Dense_1 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        """x: NCHW (channels_last) -> NCHW (channels_last)."""
        h = dw_conv(x.contiguous(), self.Conv_0.weight.to(x.dtype),
                    self.Conv_0.bias.to(x.dtype))
        h = layer_norm(self.LayerNorm_0, h.permute(0, 2, 3, 1))
        h = linear(self.Dense_1, exact_gelu(linear(self.Dense_0, h)))
        h = self.gamma.to(h.dtype) * h
        return x + self.drop_path(h.permute(0, 3, 1, 2))


@BACKBONES.register_module()
class ConvNeXt(nn.Module):
    """The JAX ConvNeXt's fields; ``out_indices`` are the stages whose
    (normed) outputs are returned."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cin, cur = 3, 0
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i == 0:
                self.stem = nn.Conv2d(3, dim, 4, 4)
                self.stem_norm = nn.LayerNorm(dim, eps=1e-6)
            else:
                self.add_module(f"down_norm{i}", nn.LayerNorm(cin, eps=1e-6))
                self.add_module(f"down{i}", nn.Conv2d(cin, dim, 2, 2))
            for j in range(depth):
                self.add_module(f"block{i}_{j}", ConvNeXtBlock(
                    dim, float(dpr[cur + j])))
            if i in self.out_indices:
                self.add_module(f"out_norm{i}", nn.LayerNorm(dim, eps=1e-6))
            cin, cur = dim, cur + depth

    def forward(self, images):
        """images: NHWC [B, H, W, 3] -> the NHWC outputs of the stages in
        ``out_indices``."""
        x = images.permute(0, 3, 1, 2)
        outs = []
        for i, depth in enumerate(self.depths):
            if i == 0:
                x = channel_norm(self.stem_norm, conv2d(self.stem, x))
            else:
                x = channel_norm(getattr(self, f"down_norm{i}"), x)
                x = conv2d(getattr(self, f"down{i}"), x)
            for j in range(depth):
                x = getattr(self, f"block{i}_{j}")(x)
            if i in self.out_indices:
                outs.append(layer_norm(getattr(self, f"out_norm{i}"),
                                       x.permute(0, 2, 3, 1)))
        return tuple(outs)


_ARCH = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_large": dict(depths=(3, 3, 27, 3),
                           dims=(192, 384, 768, 1536)),
    "convnext_xlarge": dict(depths=(3, 3, 27, 3),
                            dims=(256, 512, 1024, 2048)),
}


def _make(arch):
    @BACKBONES.register_module(name=arch)
    def ctor(pretrained=False, **kw):
        """ConvNeXt of ``arch``; ``pretrained`` is the runner's business
        and ``in_22k`` is dropped, as in JAX."""
        kw.pop("in_22k", None)
        return ConvNeXt(**{**_ARCH[arch], **kw})
    return ctor


for _arch in _ARCH:
    _make(_arch)
