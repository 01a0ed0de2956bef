"""Tile screen (counterpart of
``rs_detection_tpu/models/networks/tile_screen.py``): a small objectness
net that scores every tile of a scene for "contains any object" in one
batched pass, so that ``SceneDataset(screen=...)`` sends only the tiles
it keeps to the detector (``budget``: the top K of a scene; ``thresh``:
those whose sigmoid reaches it). ``tools/train_screen.py`` trains it on
a tiled detection dataset (label: the tile has any ground truth).

Inputs are normalized NHWC tiles, as everywhere in the port; the layout
changes to NCHW once, at the top of ``forward``, for the convs. The
submodules carry the flax names (``Conv_i``, ``GroupNorm_i``), so
``utils/jax_weights.py`` carries a flax ``TileScreen`` tree across both
ways.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import MODELS


@MODELS.register_module()
class TileScreen(nn.Module):
    """[B, S, S, 3] normalized tiles -> [B] objectness logits (f32).

    ``pool`` x ``pool`` average pooling (VALID), then per entry of
    ``channels`` a stride-2 3x3 conv (padding 1, no bias), GroupNorm with
    ``min(8, c)`` groups and flax's epsilon 1e-6 (torch's default is
    1e-5), ReLU; the head is a 1x1 conv to one channel with a bias and a
    spatial max. GroupNorm keeps a tile's score independent of the tiles
    that share its batch."""

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128),
                 pool: int = 4):
        super().__init__()
        self.channels = tuple(channels)
        self.pool = pool
        c_in = 3
        for i, c in enumerate(self.channels):
            self.add_module(f"Conv_{i}", nn.Conv2d(c_in, c, 3, stride=2,
                                                   padding=1, bias=False))
            self.add_module(f"GroupNorm_{i}",
                            nn.GroupNorm(min(8, c), c, eps=1e-6))
            c_in = c
        self.add_module(f"Conv_{len(self.channels)}", nn.Conv2d(c_in, 1, 1))
        self.reset_parameters(torch.Generator().manual_seed(0))

    def reset_parameters(self, g: torch.Generator) -> None:
        """He-normal (fan out, truncated at two deviations) conv kernels,
        zero biases, unit GroupNorm scales."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    k = m.kernel_size[0] * m.kernel_size[1]
                    std = math.sqrt(2.0 / (k * m.out_channels))
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                          2 * std, generator=g)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.pool > 1:
            x = F.avg_pool2d(x, self.pool, self.pool)
        for i in range(len(self.channels)):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.relu(getattr(self, f"GroupNorm_{i}")(x))
        logit_map = getattr(self, f"Conv_{len(self.channels)}")(x)
        return logit_map.amax(dim=(1, 2, 3)).float()


def screen_loss(logits: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Tile-level BCE with logits in its stable form, and the accuracy
    of ``logits > 0``. ``labels``: {0, 1} [B]."""
    z = logits
    y = labels.float()
    loss = z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))
    acc = ((z > 0).float() == y).float().mean()
    return loss.mean(), dict(screen_loss=loss.mean(), screen_acc=acc)
