"""VAN (Visual Attention Network) backbone.

Counterpart of ``rs_detection_tpu/models/backbones/van.py``. Public layout is the JAX one: NHWC images in,
a tuple of per-stage NHWC maps out. Inside, activations are NCHW
tensors in ``channels_last`` memory, so ``permute(0, 2, 3, 1)`` hands
the MLP kernel a contiguous NHWC buffer and cuDNN convs stay
NHWC-native. Submodule and parameter names follow the flax tree, so
``utils/jax_weights.py`` maps one onto the other by name.

``fused=True`` (off by default, ``RS_VAN_FUSED=1`` in the JAX package)
is a serving mode: in eval each block is two fused calls, ``van_attn``
(K4) and ``van_mlp_residual`` (K2r), with the eval-mode BatchNorms folded
to affines and the layer scales and both residual adds inside the
kernels. It makes no layout copy: a block's input is NCHW in
channels_last memory, whose ``permute(0, 2, 3, 1)`` is the contiguous
NHWC both kernels take. The parameters are the same in both modes.
Training ignores the flag.

``int8=True`` (off by default, ``RS_INT8=1`` in the JAX package) is the
int8 serving mode of ``ops/quant.py``: in eval the three 1x1 mixes of
the attention, the MLP's two 1x1 products (K2q, the int8 form of the MLP
kernel) and the patch-embed convs of stages 2-4 run s8 x s8 -> s32. It
composes with ``fused``: a fused int8 block is K4 as it is (it has no
int8 form) and the residual form of K2q. The parameters are the same in
every mode, and the weights are quantized on every call, so weights
loaded after construction are the ones served. Training ignores the
flag.

In training (``model.train()``) BatchNorm uses batch statistics with the
flax running update, the MLP runs its plain composition (K2 has no
backward), every depthwise conv goes through ``ops.dw_conv`` (weight
gradient K6 on CUDA), and each block is checkpointed, recomputing its
forward in the backward as the JAX ``nn.remat`` does.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.van_attn import sa_core, van_attn
from ...ops.van_mlp import (van_mlp, van_mlp_int8, van_mlp_reference,
                            van_mlp_residual, van_mlp_residual_int8)
from ..utils.modules import (BatchNorm2d, DropPath, frozen_stats,
                             maybe_int8_conv2d)


def _dw(dim: int, k: int, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(dim, dim, k, padding=dilation * (k - 1) // 2,
                     dilation=dilation, groups=dim)


class LKA(nn.Module):
    """Large-kernel attention weights: 5x5 dw, 7x7 dw dilation 3, 1x1."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = _dw(dim, 5)
        self.conv_spatial = _dw(dim, 7, dilation=3)
        self.conv1 = nn.Conv2d(dim, dim, 1)


class SpatialAttention(nn.Module):
    def __init__(self, dim: int, int8: bool = False):
        super().__init__()
        self.int8 = int8
        self.proj_1 = nn.Conv2d(dim, dim, 1)
        self.sgu = LKA(dim)
        self.proj_2 = nn.Conv2d(dim, dim, 1)

    def weights(self, dtype):
        """The ten tensors ``sa_core`` and ``van_attn`` take, in
        ``dtype``."""
        s = self.sgu
        return tuple(t.to(dtype) for t in (
            self.proj_1.weight, self.proj_1.bias, s.conv0.weight,
            s.conv0.bias, s.conv_spatial.weight, s.conv_spatial.bias,
            s.conv1.weight, s.conv1.bias, self.proj_2.weight,
            self.proj_2.bias))

    def forward(self, h):
        """h: NHWC -> NHWC."""
        return sa_core(h, *self.weights(h.dtype),
                       int8=self.int8 and not self.training)


class Mlp(nn.Module):
    """fc1 (1x1) -> dw 3x3 -> GELU -> fc2 (1x1): one ``van_mlp`` (K2 on
    CUDA) in eval; in training its plain composition, as the JAX ``Mlp``
    (``van.py:174-181``), since K2 has no backward. With ``int8`` the
    eval calls are the int8 forms (K2q on CUDA). ``int8_group`` is the
    activation-scale group of their plain version on the CPU
    (``ops/van_mlp.py``): the CUDA kernel's by default; the tests set the
    JAX package's to hold the port against it."""

    def __init__(self, dim: int, hidden: int, int8: bool = False):
        super().__init__()
        self.int8 = int8
        self.int8_group = "tile"
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dwconv = _dw(hidden, 3)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, h):
        """h: contiguous NHWC -> NHWC."""
        hid, dim = self.fc1.weight.shape[:2]
        args = (h, *(t.to(h.dtype) for t in (
            self.fc1.weight.view(hid, dim), self.fc1.bias,
            self.dwconv.weight.view(hid, 9), self.dwconv.bias,
            self.fc2.weight.view(dim, hid), self.fc2.bias)))
        if self.training:
            return van_mlp_reference(*args)
        if self.int8:
            return van_mlp_int8(*args, group=self.int8_group)
        return van_mlp(*args)

    def forward_fused(self, x, a2, b2, ls2):
        """``x + ls2 * mlp(a2 * x + b2)`` on the raw block input x
        (contiguous NHWC), as one ``van_mlp_residual``: the bn2 affine
        folds into fc1 and the layer scale into fc2. The folds are made
        in f32 and cast once, or bf16 would lose the ``w1 @ b2`` term at
        wide C. The int8 form quantizes the folded, cast weights, as the
        JAX ``Mlp`` hands them to its kernel."""
        hid, dim = self.fc1.weight.shape[:2]
        dt = x.dtype
        w1 = self.fc1.weight.view(hid, dim).float()
        w2 = self.fc2.weight.view(dim, hid).float()
        ls2 = ls2.float()
        args = (
            x, (w1 * a2).to(dt),
            (self.fc1.bias.float() + (w1 * b2).sum(1)).to(dt),
            self.dwconv.weight.view(hid, 9).to(dt), self.dwconv.bias.to(dt),
            (w2 * ls2[:, None]).to(dt), (self.fc2.bias.float() * ls2).to(dt))
        if self.int8:
            return van_mlp_residual_int8(*args, group=self.int8_group)
        return van_mlp_residual(*args)


class VANBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0, fused: bool = False,
                 int8: bool = False):
        super().__init__()
        self.fused = fused
        self.norm1 = BatchNorm2d(dim)
        self.attn = SpatialAttention(dim, int8=int8)
        self.norm2 = BatchNorm2d(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), int8=int8)
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        """x: NCHW (channels_last) -> NCHW (channels_last)."""
        if self.fused and not self.training:
            # two kernels per block; the permutes are views both ways
            xh = x.permute(0, 2, 3, 1)
            xh = van_attn(xh, *self.norm1.folded_affine(),
                          *self.attn.weights(x.dtype),
                          self.layer_scale_1.to(x.dtype))
            xh = self.mlp.forward_fused(xh, *self.norm2.folded_affine(),
                                        self.layer_scale_2)
            return xh.permute(0, 3, 1, 2)
        ls1 = self.layer_scale_1.to(x.dtype).view(1, -1, 1, 1)
        ls2 = self.layer_scale_2.to(x.dtype).view(1, -1, 1, 1)
        h = self.attn(self.norm1(x).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        x = x + self.drop_path(ls1 * h)
        h = self.norm2(x).permute(0, 2, 3, 1).contiguous()
        h = self.mlp(h).permute(0, 3, 1, 2)
        return x + self.drop_path(ls2 * h)

    def checkpoint_contexts(self):
        """``torch.utils.checkpoint`` contexts (forward, recompute): the
        recomputed forward leaves the BN running statistics alone."""
        return contextlib.nullcontext(), frozen_stats(self.norm1, self.norm2)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int, patch: int, stride: int,
                 int8: bool = False):
        super().__init__()
        self.int8 = int8
        self.proj = nn.Conv2d(cin, dim, patch, stride, padding=patch // 2)
        self.norm = BatchNorm2d(dim)

    def forward(self, x):
        # the RGB stem (3 input channels) stays as it is under int8
        return self.norm(maybe_int8_conv2d(
            self.proj, x, self.int8 and not self.training))


class VAN(nn.Module):
    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 mlp_ratios: Sequence[float] = (8, 8, 4, 4),
                 depths: Sequence[int] = (3, 5, 27, 3),
                 drop_path_rate: float = 0.0, fused: bool = False,
                 int8: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cin, cur = 3, 0
        for i, (dim, depth) in enumerate(zip(embed_dims, depths)):
            self.add_module(f"patch_embed{i + 1}", OverlapPatchEmbed(
                cin, dim, patch=7 if i == 0 else 3,
                stride=4 if i == 0 else 2, int8=int8))
            for j in range(depth):
                self.add_module(f"block{i + 1}_{j}", VANBlock(
                    dim, mlp_ratios[i], float(dpr[cur + j]), fused=fused,
                    int8=int8))
            self.add_module(f"norm{i + 1}", nn.LayerNorm(dim, eps=1e-6))
            cin, cur = dim, cur + depth

    def forward(self, images):
        """images: NHWC [B, H, W, 3] -> the 4 NHWC stage outputs."""
        x = images.permute(0, 3, 1, 2)
        outs = []
        remat = self.training and torch.is_grad_enabled()
        for i, depth in enumerate(self.depths):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            for j in range(depth):
                block = getattr(self, f"block{i + 1}_{j}")
                if remat:
                    # saves each block's input only: the 38 blocks' MLP
                    # hidden tensors (4-8x wide) would not fit otherwise
                    x = checkpoint(block, x, use_reentrant=False,
                                   context_fn=block.checkpoint_contexts)
                else:
                    x = block(x)
            norm = getattr(self, f"norm{i + 1}")
            y = F.layer_norm(x.permute(0, 2, 3, 1), norm.normalized_shape,
                             norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                             norm.eps)
            outs.append(y)
            x = y.permute(0, 3, 1, 2)
        return tuple(outs)
