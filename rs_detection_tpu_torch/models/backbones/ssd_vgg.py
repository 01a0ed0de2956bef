"""SSD's VGG-16 backbone (counterpart of
``rs_detection_tpu/models/backbones/ssd_vgg.py``): the five VGG-16 conv
stages (3x3, ReLU) with 2x2 stride-2 max pools after the first four
(floor mode: 300 -> 150 -> 75 -> 37 -> 18), pool5 3x3 stride 1 pad 1,
fc6 3x3 with dilation 6 and padding 6, fc7 1x1, and ``L2Norm`` on
conv4_3. Returns ``(l2norm(conv4_3), fc7)`` in NHWC; the convs run on the
NCHW view. Layer names are the flax ones: ``conv{s}_{j}``, ``l2norm``
(``gamma``), ``fc6``, ``fc7``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..utils.modules import conv2d

VGG16 = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class L2Norm(nn.Module):
    """``gamma * x / sqrt(sum(x^2) + 1e-10)`` over the channels of an
    NCHW tensor, the JAX form exactly (``F.normalize`` clamps the norm
    instead), ``gamma`` starting at ``scale``."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(1, keepdim=True) + 1e-10)
        return self.gamma.to(x.dtype)[:, None, None] * x / norm


@BACKBONES.register_module()
class SSDVGG(nn.Module):
    """The JAX module's fields. ``input_size`` is kept for the configs
    (the network is fully convolutional); ``out_feature_indices`` picks
    conv4_3 (3) and fc7 (4)."""

    def __init__(self, input_size: int = 300,
                 out_feature_indices: Sequence[int] = (3, 4)):
        super().__init__()
        self.input_size = input_size
        self.out_feature_indices = tuple(out_feature_indices)
        cin = 3
        for si, (ch, n) in enumerate(VGG16):
            for j in range(n):
                self.add_module(f"conv{si + 1}_{j + 1}",
                                nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        if 3 in self.out_feature_indices:
            self.l2norm = L2Norm(512)
        self.fc6 = nn.Conv2d(512, 1024, 3, padding=6, dilation=6)
        self.fc7 = nn.Conv2d(1024, 1024, 1)

    def forward(self, images, train: bool = False):
        """images NHWC [B, H, W, 3] -> the NHWC features picked by
        ``out_feature_indices``. ``train`` changes nothing."""
        x = images.permute(0, 3, 1, 2)
        outs = []
        for si, (_, n) in enumerate(VGG16):
            for j in range(n):
                x = F.relu(conv2d(getattr(self, f"conv{si + 1}_{j + 1}"), x))
            if si == 3 and 3 in self.out_feature_indices:
                outs.append(self.l2norm(x).permute(0, 2, 3, 1))
            if si < 4:
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.max_pool2d(x, 3, 1, 1)
        x = F.relu(conv2d(self.fc6, x))
        x = F.relu(conv2d(self.fc7, x))
        if 4 in self.out_feature_indices:
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


@BACKBONES.register_module(name="SSD_VGG16")
def ssd_vgg16(input_size=300, pretrained=None, **kw):
    """The zoo's name: ``SSDVGG`` with the default outputs (the JAX
    constructor drops ``out_feature_indices`` and ``pretrained``; the
    runner reads ``pretrained``)."""
    return SSDVGG(input_size=input_size)
