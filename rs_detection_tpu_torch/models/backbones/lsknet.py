"""LSKNet backbone (counterpart of
``rs_detection_tpu/models/backbones/lsknet.py``): large selective kernel
attention (a 5x5 and a 7x7 dilation-3 depthwise branch, spatial attention
over their channel mean and max, selective fusion) inside VAN-style
blocks (BN, the conv-MLP, layer scales), with VAN's ``Mlp`` and
``OverlapPatchEmbed``; ``lsknet_t`` and ``lsknet_s``.

Public layout as in VAN: NHWC images in, a tuple of NHWC stage outputs
out, NCHW tensors in ``channels_last`` memory inside. Submodule names
follow the flax tree, so ``utils/jax_weights.py`` maps one onto the
other by name.

The MLP is VAN's ``Mlp``: K2 on CUDA in eval (K2q with ``int8``), its
plain composition in training, whose depthwise 3x3 goes through
``ops.dw_conv`` as both LSK depthwise convs do (weight gradient K6 on
CUDA: three launches a block in a training step). The JAX block calls
its ``Mlp`` without ``train``, so there the eval branch serves training
too: on a TPU the Pallas kernel (whose backward is the same plain
composition), and under ``RS_INT8=1`` the quantized MLP. The port trains
in float whatever ``int8`` says (ROADMAP, Queue 3). ``int8`` also runs
the patch embeds of stages 2-4 as int8 products in eval, as JAX's
``OverlapPatchEmbed`` does under ``RS_INT8=1``. JAX's LSKNet has no
remat, and neither has this one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...ops.activations import exact_gelu
from ...ops.dw_conv import dw_conv
from ...utils.registry import BACKBONES
from ..utils.modules import BatchNorm2d, DropPath, conv2d, layer_norm
from .van import Mlp, OverlapPatchEmbed, _dw


class LSKModule(nn.Module):
    """Large Selective Kernel unit (the reference's ``LSKblock``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = _dw(dim, 5)
        self.conv_spatial = _dw(dim, 7, dilation=3)
        self.conv1 = nn.Conv2d(dim, dim // 2, 1)
        self.conv2 = nn.Conv2d(dim, dim // 2, 1)
        self.conv_squeeze = nn.Conv2d(2, 2, 7, padding=3)
        self.conv = nn.Conv2d(dim // 2, dim, 1)

    def forward(self, x):
        """x: NCHW (channels_last) -> NCHW (channels_last)."""
        dt = x.dtype
        a1 = dw_conv(x, self.conv0.weight.to(dt), self.conv0.bias.to(dt))
        # cuDNN runs the dilated depthwise conv far faster in NCHW, as in
        # VAN's attention (ops/van_attn.py:sa_core)
        a2 = dw_conv(a1.contiguous(), self.conv_spatial.weight.to(dt),
                     self.conv_spatial.bias.to(dt), dilation=3) \
            .contiguous(memory_format=torch.channels_last)
        a1 = conv2d(self.conv1, a1)
        a2 = conv2d(self.conv2, a2)
        attn = torch.cat([a1, a2], dim=1)
        agg = torch.cat([attn.mean(dim=1, keepdim=True),
                         attn.amax(dim=1, keepdim=True)], dim=1)
        sig = torch.sigmoid(conv2d(self.conv_squeeze, agg))
        fused = a1 * sig[:, 0:1] + a2 * sig[:, 1:2]
        return x * conv2d(self.conv, fused)


class LSKAttention(nn.Module):

    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.spatial_gating_unit = LSKModule(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x):
        h = exact_gelu(conv2d(self.proj_1, x))
        h = self.spatial_gating_unit(h)
        return conv2d(self.proj_2, h) + x


class LSKBlock(nn.Module):

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, int8: bool = False):
        super().__init__()
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.norm1 = BatchNorm2d(dim)
        self.attn = LSKAttention(dim)
        self.norm2 = BatchNorm2d(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), int8=int8)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        """x: NCHW (channels_last) -> NCHW (channels_last)."""
        ls1 = self.layer_scale_1.to(x.dtype).view(1, -1, 1, 1)
        ls2 = self.layer_scale_2.to(x.dtype).view(1, -1, 1, 1)
        x = x + self.drop_path(ls1 * self.attn(self.norm1(x)))
        h = self.norm2(x).permute(0, 2, 3, 1).contiguous()
        h = self.mlp(h).permute(0, 3, 1, 2)
        return x + self.drop_path(ls2 * h)


@BACKBONES.register_module()
class LSKNet(nn.Module):
    """The JAX LSKNet's fields; ``int8`` (off by default, ignored in
    training) serves the MLPs through K2q and the patch embeds of stages
    2-4 as int8 products."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 depths: Sequence[int] = (2, 2, 4, 2),
                 drop_path_rate: float = 0.0,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 int8: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cin, cur = 3, 0
        for i, (dim, depth) in enumerate(zip(embed_dims, depths)):
            self.add_module(f"patch_embed{i + 1}", OverlapPatchEmbed(
                cin, dim, patch=7 if i == 0 else 3,
                stride=4 if i == 0 else 2, int8=int8))
            for j in range(depth):
                self.add_module(f"block{i + 1}_{j}", LSKBlock(
                    dim, mlp_ratios[i], float(dpr[cur + j]), int8=int8))
            self.add_module(f"norm{i + 1}", nn.LayerNorm(dim, eps=1e-6))
            cin, cur = dim, cur + depth

    def forward(self, images):
        """images: NHWC [B, H, W, 3] -> the NHWC outputs of the stages in
        ``out_indices``."""
        x = images.permute(0, 3, 1, 2)
        outs = []
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            for j in range(depth):
                x = getattr(self, f"block{i + 1}_{j}")(x)
            y = layer_norm(getattr(self, f"norm{i + 1}"),
                           x.permute(0, 2, 3, 1))
            if i in self.out_indices:
                outs.append(y)
            x = y.permute(0, 3, 1, 2)
        return tuple(outs)


@BACKBONES.register_module(name="lsknet_t")
def _lsknet_t(pretrained=False, **kw):
    return LSKNet(embed_dims=(32, 64, 160, 256), depths=(3, 3, 5, 2), **kw)


@BACKBONES.register_module(name="lsknet_s")
def _lsknet_s(pretrained=False, **kw):
    return LSKNet(embed_dims=(64, 128, 320, 512), depths=(2, 2, 4, 2), **kw)
