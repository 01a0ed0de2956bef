"""ResNet backbone family (counterpart of
``rs_detection_tpu/models/backbones/resnet.py``): depths
18/26/34/38/50/101/152, the ``_v1d`` forms (deep stem, average-pool
shortcut), the stage outputs named in ``return_stages``,
``frozen_stages`` and ``norm_eval``.

Public layout as in VAN: NHWC images in, a tuple of NHWC stage outputs
out; inside, NCHW tensors in ``channels_last`` memory, so cuDNN's convs
stay NHWC-native. Submodule names follow the flax tree (``Conv_k`` /
``Norm_k`` in the order the JAX ``nn.compact`` code creates them, blocks
``layer{i}_{b}``), so ``utils/jax_weights.py`` maps one onto the other
by name.

The JAX model freezes as follows, and so does this one:

* a norm runs on its running statistics, and never moves them, where JAX
  passes it ``train=False``: every norm with ``norm_eval``, the stem's
  when ``frozen_stages >= 0``, and a frozen stage's. Its scale and bias
  still train. ``train(mode)`` keeps those norms in eval mode;
* the outputs of the stem (``frozen_stages >= 0``) and of each frozen
  stage are cut from autograd (``stop_gradient`` there, ``detach`` here).
  Nothing masks the optimizer, so the training step gives the frozen
  parameters zero gradients and their weight decay and momentum still
  move them, as optax does (``parallel/train_step.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..utils.modules import BatchNorm2d, conv2d


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.Conv_0 = _conv(cin, planes, 3, stride)
        self.Norm_0 = BatchNorm2d(planes)
        self.Conv_1 = _conv(planes, planes, 3)
        self.Norm_1 = BatchNorm2d(planes)
        self.downsample = downsample
        if downsample:
            self.Conv_2 = _conv(cin, planes, 1, stride)
            self.Norm_2 = BatchNorm2d(planes)

    def forward(self, x):
        out = F.relu(self.Norm_0(conv2d(self.Conv_0, x)))
        out = self.Norm_1(conv2d(self.Conv_1, out))
        identity = self.Norm_2(conv2d(self.Conv_2, x)) if self.downsample \
            else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, avg_down: bool = False):
        super().__init__()
        self.Conv_0 = _conv(cin, planes, 1)
        self.Norm_0 = BatchNorm2d(planes)
        self.Conv_1 = _conv(planes, planes, 3, stride)
        self.Norm_1 = BatchNorm2d(planes)
        self.Conv_2 = _conv(planes, planes * 4, 1)
        self.Norm_2 = BatchNorm2d(planes * 4)
        self.downsample = downsample
        # v1d: the shortcut average-pools, then a stride-1 1x1 conv
        self.pool_stride = stride if avg_down and stride > 1 else 1
        if downsample:
            self.Conv_3 = _conv(cin, planes * 4, 1,
                                1 if self.pool_stride > 1 else stride)
            self.Norm_3 = BatchNorm2d(planes * 4)

    def forward(self, x):
        out = F.relu(self.Norm_0(conv2d(self.Conv_0, x)))
        out = F.relu(self.Norm_1(conv2d(self.Conv_1, out)))
        out = self.Norm_2(conv2d(self.Conv_2, out))
        identity = x
        if self.downsample:
            if self.pool_stride > 1:
                identity = F.avg_pool2d(identity, self.pool_stride)
            identity = self.Norm_3(conv2d(self.Conv_3, identity))
        return F.relu(out + identity)


_ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    26: (Bottleneck, (2, 2, 2, 2)),
    38: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """The JAX ResNet's fields; stage names in ``return_stages`` are
    layer1..layer4."""

    def __init__(self, depth: int = 50,
                 return_stages: Sequence[str] = ("layer1", "layer2",
                                                 "layer3", "layer4"),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 deep_stem: bool = False, avg_down: bool = False):
        super().__init__()
        block_cls, layers = _ARCH[depth]
        self.layers = layers
        self.return_stages = tuple(return_stages)
        self.frozen_stages = frozen_stages
        # (cin, cout, kernel, stride) of each conv of the stem
        stem = [(3, 32, 3, 2), (32, 32, 3, 1), (32, 64, 3, 1)] if deep_stem \
            else [(3, 64, 7, 2)]
        for i, (cin, cout, k, s) in enumerate(stem):
            self.add_module(f"Conv_{i}", _conv(cin, cout, k, s))
            self.add_module(f"Norm_{i}", BatchNorm2d(cout))
        self.stem_depth = len(stem)
        # the norms JAX runs with train=False (running statistics, frozen)
        eval_norms = [f"Norm_{i}" for i in range(len(stem))] \
            if frozen_stages >= 0 or norm_eval else []
        cin, planes = 64, 64
        for stage, n_blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            frozen = stage + 1 <= frozen_stages
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or cin != planes * block_cls.expansion)
                name = f"layer{stage + 1}_{b}"
                kw = dict(avg_down=avg_down) if block_cls is Bottleneck else {}
                self.add_module(name, block_cls(cin, planes, s, ds, **kw))
                if frozen or norm_eval:
                    eval_norms += [f"{name}.{n}" for n, m in
                                   getattr(self, name).named_children()
                                   if isinstance(m, BatchNorm2d)]
                cin = planes * block_cls.expansion
            planes *= 2
        self.eval_norms = tuple(eval_norms)

    def train(self, mode: bool = True):
        super().train(mode)
        for name in self.eval_norms:
            self.get_submodule(name).eval()
        return self

    def forward(self, images):
        """images: NHWC [B, H, W, 3] -> the NHWC outputs of the stages in
        ``return_stages``."""
        x = images.permute(0, 3, 1, 2)
        for i in range(self.stem_depth):
            x = F.relu(getattr(self, f"Norm_{i}")(
                conv2d(getattr(self, f"Conv_{i}"), x)))
        if self.frozen_stages >= 0:
            x = x.detach()
        # the JAX max-pool pads with -inf, as this one does
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for stage, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            if stage + 1 <= self.frozen_stages:
                x = x.detach()
            if f"layer{stage + 1}" in self.return_stages:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


def _register(depth, **defaults):
    name = f"Resnet{depth}" + ("_v1d" if defaults.get("deep_stem") else "")

    @BACKBONES.register_module(name=name)
    def ctor(**kw):
        """ResNet of this depth; ``pretrained`` is the runner's business,
        as in the JAX constructor."""
        cfg = dict(defaults)
        kw.pop("pretrained", None)
        cfg.update(kw)
        return ResNet(depth=depth, **cfg)

    return ctor


for _d in (18, 26, 34, 38, 50, 101, 152):
    _register(_d)
for _d in (50, 101):
    _register(_d, deep_stem=True, avg_down=True)
