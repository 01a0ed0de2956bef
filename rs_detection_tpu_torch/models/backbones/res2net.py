"""Res2Net backbone (counterpart of
``rs_detection_tpu/models/backbones/res2net.py``): the Bottle2neck
multi-scale residual (the 3x3 stage split into ``scales`` groups, each
group's conv taking the previous group's output added in), ``base_width``
channel sizing, the v1b deep stem and average-pool shortcut;
``res2net50_v1b`` and ``res2net101_v1b``.

Public layout as in ResNet: NHWC images in, a tuple of NHWC stage
outputs out, NCHW tensors in ``channels_last`` memory inside. Submodule
names follow the flax tree: ``Conv_k`` / ``Norm_k`` in the order the JAX
``nn.compact`` code creates them (per block the 1x1 reduce, the
``scales - 1`` hierarchical 3x3s, the 1x1 expand, then the shortcut's
1x1; the stem's three at the top level), blocks ``layer{i}_{b}``.

As in JAX: the pools count their padding (flax ``avg_pool``); the
shortcut pools with floor; the stem's max-pool pads with -inf. The
padded pools run in NCHW (``padded_avg_pool``). With
``norm_eval`` (the default) every norm runs on its running statistics in
training too and never moves them; ``train(mode)`` keeps them in eval
mode.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..utils.modules import BatchNorm2d, conv2d

LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups,
                     bias=False)


def bn_relu(norm, conv, x):
    return F.relu(norm(conv2d(conv, x)))


def padded_avg_pool(x, stride: int):
    """The 3x3 average pool with padding 1 that counts the padding (flax
    ``avg_pool``), run on an NCHW copy and handed back in channels_last:
    PyTorch's CUDA backward of a padded ``avg_pool2d`` in channels_last
    gives wrong input gradients (torch 2.11 on an H100: off by up to 90%
    of the largest; the CPU's and NCHW's agree,
    ``tests/test_torch_other_backbones_cuda.py``)."""
    return F.avg_pool2d(x.contiguous(), 3, stride, 1).contiguous(
        memory_format=torch.channels_last)


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 26,
                 scales: int = 4, stype: str = "normal"):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.width, self.scales, self.stride = width, scales, stride
        self.stype, self.downsample = stype, downsample
        self.Conv_0 = _conv(cin, width * scales, 1)
        self.Norm_0 = BatchNorm2d(width * scales)
        for i in range(1, scales):
            self.add_module(f"Conv_{i}", _conv(width, width, 3, stride))
            self.add_module(f"Norm_{i}", BatchNorm2d(width))
        out = planes * self.expansion
        self.add_module(f"Conv_{scales}", _conv(width * scales, out, 1))
        self.add_module(f"Norm_{scales}", BatchNorm2d(out))
        if downsample:
            self.add_module(f"Conv_{scales + 1}", _conv(cin, out, 1))
            self.add_module(f"Norm_{scales + 1}", BatchNorm2d(out))

    def forward(self, x):
        s = self.scales
        out = bn_relu(self.Norm_0, self.Conv_0, x)
        splits = torch.split(out, self.width, dim=1)
        outs, prev = [], None
        for i in range(s - 1):
            sp = splits[i]
            if prev is not None and self.stype == "normal" \
                    and self.stride == 1:
                sp = sp + prev
            prev = bn_relu(getattr(self, f"Norm_{i + 1}"),
                           getattr(self, f"Conv_{i + 1}"), sp)
            outs.append(prev)
        last = splits[-1]
        if self.stride != 1 or self.stype == "stage":
            last = padded_avg_pool(last, self.stride)
        out = getattr(self, f"Norm_{s}")(conv2d(
            getattr(self, f"Conv_{s}"), torch.cat(outs + [last], dim=1)))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = getattr(self, f"Norm_{s + 1}")(conv2d(
                getattr(self, f"Conv_{s + 1}"), identity))
        return F.relu(out + identity)


class DeepStemNet(nn.Module):
    """What Res2Net and SK2Res2Net share: the v1b deep stem (three 3x3
    convs, ``Conv_0-2`` / ``Norm_0-2``), the -inf-padded max-pool, four
    stages of ``block(cin, planes, stride, downsample, stype)`` named
    ``layer{i}_{b}``, ``return_stages`` and ``norm_eval``."""

    def __init__(self, depth: int, block, return_stages: Sequence[str],
                 norm_eval: bool):
        super().__init__()
        self.layers = LAYERS[depth]
        self.return_stages = tuple(return_stages)
        self.norm_eval = norm_eval
        for i, (cin, cout, s) in enumerate(((3, 32, 2), (32, 32, 1),
                                            (32, 64, 1))):
            self.add_module(f"Conv_{i}", _conv(cin, cout, 3, s))
            self.add_module(f"Norm_{i}", BatchNorm2d(cout))
        cin, planes = 64, 64
        for stage, n_blocks in enumerate(self.layers):
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or cin != planes * 4)
                self.add_module(f"layer{stage + 1}_{b}", block(
                    cin, planes, s, ds, "stage" if b == 0 else "normal"))
                cin = planes * 4
            planes *= 2

    def train(self, mode: bool = True):
        super().train(mode)
        if self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        return self

    def forward(self, images):
        """images: NHWC [B, H, W, 3] -> the NHWC outputs of the stages in
        ``return_stages``."""
        x = images.permute(0, 3, 1, 2)
        for i in range(3):
            x = bn_relu(getattr(self, f"Norm_{i}"), getattr(self, f"Conv_{i}"),
                        x)
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            if f"layer{stage + 1}" in self.return_stages:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


@BACKBONES.register_module()
class Res2Net(DeepStemNet):
    """The JAX Res2Net's fields."""

    def __init__(self, depth: int = 50, base_width: int = 26,
                 scales: int = 4,
                 return_stages: Sequence[str] = ("layer1", "layer2",
                                                 "layer3", "layer4"),
                 norm_eval: bool = True):
        if depth not in (50, 101):
            raise KeyError(depth)

        def block(cin, planes, stride, ds, stype):
            return Bottle2neck(cin, planes, stride, ds, base_width, scales,
                               stype)

        super().__init__(depth, block, return_stages, norm_eval)


@BACKBONES.register_module(name="res2net50_v1b")
def _res2net50(pretrained=False, **kw):
    return Res2Net(depth=50, **kw)


@BACKBONES.register_module(name="res2net101_v1b")
def _res2net101(pretrained=False, **kw):
    return Res2Net(depth=101, **kw)
