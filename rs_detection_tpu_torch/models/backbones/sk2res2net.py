"""SK2Res2Net backbone (counterpart of
``rs_detection_tpu/models/backbones/sk2res2net.py``): a Res2Net whose
bottleneck adds a selective-kernel gate (``SKLayer``) between the tensor
before the hierarchical convs and their output, grouped
(``cardinality``) 3x3 convs, and a stage start that average-pools the
whole reduced tensor before the split; ``sk2res2net101_v1b``.

Layout, stem, stages, ``norm_eval`` and the flax names as in
``res2net.py``; per block ``Conv_0`` / ``Norm_0`` (1x1 reduce),
``Conv_1-3`` / ``Norm_1-3`` (the hierarchical 3x3s at ``scales`` = 4),
``sk`` (``alpha``, ``proj1``, ``Norm_0``, ``proj2``), ``Conv_4`` /
``Norm_4`` (1x1 expand), ``Conv_5`` / ``Norm_5`` (the shortcut).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..utils.modules import BatchNorm2d, conv2d
from .res2net import DeepStemNet, _conv, bn_relu, padded_avg_pool


class SKLayer(nn.Module):
    """Selective-kernel gate: ``x + sigmoid(proj(fuse)) * (fx - x)``,
    ``fuse`` blending the spatial means of x and fx by the learned
    ``sigmoid(alpha)``."""

    def __init__(self, c: int, ratio: int = 8):
        super().__init__()
        hidden = max(32, c // ratio)
        self.alpha = nn.Parameter(torch.zeros(1))
        self.proj1 = nn.Conv2d(c, hidden, 1, bias=False)
        self.Norm_0 = BatchNorm2d(hidden)
        self.proj2 = nn.Conv2d(hidden, c, 1)

    def forward(self, x, fx):
        a = torch.sigmoid(self.alpha.to(x.dtype))
        fuse = a * x.mean(dim=(2, 3), keepdim=True) \
            + (1.0 - a) * fx.mean(dim=(2, 3), keepdim=True)
        h = bn_relu(self.Norm_0, self.proj1, fuse)
        return x + torch.sigmoid(conv2d(self.proj2, h)) * (fx - x)


class SK2Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 26,
                 scales: int = 4, cardinality: int = 1, ratio: int = 8,
                 stype: str = "normal"):
        super().__init__()
        width = int(math.floor(planes * (base_width / 64.0)))
        self.width, self.scales, self.stride = width, scales, stride
        self.stype, self.downsample = stype, downsample
        self.Conv_0 = _conv(cin, width * scales, 1)
        self.Norm_0 = BatchNorm2d(width * scales)
        for i in range(1, scales):
            self.add_module(f"Conv_{i}", _conv(width, width, 3,
                                               groups=cardinality))
            self.add_module(f"Norm_{i}", BatchNorm2d(width))
        self.sk = SKLayer(width * scales, ratio)
        out = planes * self.expansion
        self.add_module(f"Conv_{scales}", _conv(width * scales, out, 1))
        self.add_module(f"Norm_{scales}", BatchNorm2d(out))
        if downsample:
            self.add_module(f"Conv_{scales + 1}", _conv(cin, out, 1))
            self.add_module(f"Norm_{scales + 1}", BatchNorm2d(out))

    def forward(self, x):
        s = self.scales
        out = bn_relu(self.Norm_0, self.Conv_0, x)
        if self.stype == "stage" and self.stride != 1:
            out = padded_avg_pool(out, self.stride)
        splits = torch.split(out, self.width, dim=1)
        outs, prev = [], None
        for i in range(s - 1):
            sp = splits[i]
            if prev is not None and self.stype == "normal":
                sp = sp + prev
            prev = bn_relu(getattr(self, f"Norm_{i + 1}"),
                           getattr(self, f"Conv_{i + 1}"), sp)
            outs.append(prev)
        fx = self.sk(out, torch.cat(outs + [splits[-1]], dim=1))
        out = getattr(self, f"Norm_{s}")(conv2d(getattr(self, f"Conv_{s}"),
                                                fx))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = getattr(self, f"Norm_{s + 1}")(conv2d(
                getattr(self, f"Conv_{s + 1}"), identity))
        return F.relu(out + identity)


@BACKBONES.register_module()
class SK2Res2Net(DeepStemNet):
    """The JAX SK2Res2Net's fields."""

    def __init__(self, depth: int = 101, base_width: int = 26,
                 scales: int = 4, cardinality: int = 1, ratio: int = 8,
                 return_stages: Sequence[str] = ("layer1", "layer2",
                                                 "layer3", "layer4"),
                 norm_eval: bool = True):
        def block(cin, planes, stride, ds, stype):
            return SK2Bottle2neck(cin, planes, stride, ds, base_width,
                                  scales, cardinality, ratio, stype)

        super().__init__(depth, block, return_stages, norm_eval)


@BACKBONES.register_module(name="sk2res2net101_v1b")
def _sk2res2net101(pretrained=False, **kw):
    return SK2Res2Net(depth=101, **kw)
