"""Feature Pyramid Network (counterpart of
``rs_detection_tpu/models/necks/fpn.py``): lateral 1x1 convs, top-down
nearest upsample, 3x3 output convs, extra levels by stride-2
subsampling (flax ``max_pool((1, 1), (2, 2))``). NHWC in and out.
``int8=True`` serves the lateral and output convs through
``ops.quant.int8_conv`` (eval only; the same parameters).
``no_norm_on_lateral`` and ``upsample_cfg`` are accepted and have no
effect, as in the JAX package (nearest 2x upsampling, no norms)."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.registry import NECKS
from ..utils.modules import maybe_int8_conv2d


def _upsample_nearest(x, shape):
    """Integer-ratio nearest upsample of NCHW ``x`` cropped to ``shape``
    (the JAX repeat-then-crop), returned in channels_last memory."""
    n, c, h, w = x.shape
    th, tw = shape
    ry, rx = th // h, tw // w
    t = x.permute(0, 2, 3, 1)[:, :, None, :, None, :] \
        .expand(n, h, ry, w, rx, c).reshape(n, h * ry, w * rx, c)
    return t[:, :th, :tw].permute(0, 3, 1, 2)


@NECKS.register_module()
class FPN(nn.Module):
    """Inputs ``start_level`` to ``end_level`` (exclusive; -1 = all) feed
    the pyramid, as in the JAX FPN."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs=False, relu_before_extra_convs: bool = False,
                 no_norm_on_lateral: bool = True, upsample_cfg=None,
                 int8: bool = False):
        super().__init__()
        self.int8 = int8
        if add_extra_convs or relu_before_extra_convs:
            raise NotImplementedError(
                "FPN add_extra_convs / relu_before_extra_convs are not ported "
                "yet (ROADMAP.md, Queue 1: remaining FPN modes); only the "
                "max-pool extra levels are")
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end_level = (len(self.in_channels) if end_level == -1
                          else end_level)
        used = self.in_channels[self.start_level:self.end_level]
        for i, cin in enumerate(used):
            self.add_module(f"lateral_{i}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_conv_{i}", nn.Conv2d(
                out_channels, out_channels, 3, padding=1))

    def forward(self, inputs):
        """inputs: NHWC maps (one per in_channels) -> tuple of NHWC."""
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"FPN takes {len(self.in_channels)} inputs, "
                             f"got {len(inputs)}")
        int8 = self.int8 and not self.training
        used = inputs[self.start_level:self.end_level]
        lat = [maybe_int8_conv2d(getattr(self, f"lateral_{i}"),
                                 f.permute(0, 3, 1, 2), int8)
               for i, f in enumerate(used)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + _upsample_nearest(lat[i],
                                                        lat[i - 1].shape[2:])
        outs = [maybe_int8_conv2d(getattr(self, f"fpn_conv_{i}"), x, int8)
                for i, x in enumerate(lat)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
