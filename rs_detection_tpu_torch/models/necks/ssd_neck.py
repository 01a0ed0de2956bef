"""SSD's extra-feature neck (counterpart of
``rs_detection_tpu/models/necks/ssd_neck.py``): after the backbone's
levels, pairs of a 1x1 reduce conv and a 3x3 conv (each with a ReLU),
``extra{i}_reduce`` / ``extra{i}_conv``, each pair from the last level,
so SSD300 gets six levels. NHWC in and out; the convs run on the NCHW
view. The constructor registered as ``SSDNeck`` reads both schemas: the
``extra_cfg`` tuples and the zoo's flat channel / stride / padding
lists."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F
from torch import nn

from ...utils.registry import NECKS
from ..utils.modules import conv2d

EXTRA_CFG = ((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0),
             (128, 256, 1, 0))


class SSDNeck(nn.Module):
    """``extra_cfg``: (reduce channels, out channels, stride, padding) a
    pair; ``in_channels`` the width of the last input level (fc7's
    1024). The JAX convs infer their input width; here the first reduce
    conv takes ``in_channels`` and each later one the pair before's
    output."""

    def __init__(self, extra_cfg: Sequence[Tuple[int, int, int, int]] =
                 EXTRA_CFG, in_channels: int = 1024):
        super().__init__()
        self.extra_cfg = tuple(tuple(e) for e in extra_cfg)
        cin = in_channels
        for i, (red, out, stride, pad) in enumerate(self.extra_cfg):
            self.add_module(f"extra{i}_reduce", nn.Conv2d(cin, red, 1))
            self.add_module(f"extra{i}_conv", nn.Conv2d(
                red, out, 3, stride=stride, padding=pad))
            cin = out

    def forward(self, inputs, train: bool = False):
        """The input levels, then one level a pair, all NHWC."""
        outs = list(inputs)
        x = inputs[-1].permute(0, 3, 1, 2)
        for i in range(len(self.extra_cfg)):
            x = F.relu(conv2d(getattr(self, f"extra{i}_reduce"), x))
            x = F.relu(conv2d(getattr(self, f"extra{i}_conv"), x))
            outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


@NECKS.register_module(name="SSDNeck")
def ssd_neck(extra_cfg=None, in_channels=(512, 1024),
             out_channels=(512, 1024, 512, 256, 256, 256),
             level_strides=(2, 2, 1, 1), level_paddings=(1, 1, 0, 0),
             l2_norm_scale=20, **kw):
    """The JAX constructor: ``extra_cfg`` as given, else one pair a level
    after the inputs, reducing to ``max(out // 2, 128)``. As in JAX,
    ``l2_norm_scale`` is not read (the backbone's ``L2Norm`` starts at
    20)."""
    if extra_cfg is None:
        n_base = len(in_channels)
        extra_cfg = [(max(out_channels[n_base + i] // 2, 128),
                      out_channels[n_base + i], stride, pad)
                     for i, (stride, pad) in enumerate(zip(level_strides,
                                                           level_paddings))]
    return SSDNeck(extra_cfg=extra_cfg, in_channels=in_channels[-1])
