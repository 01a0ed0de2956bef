"""Shared layers (counterpart of ``rs_detection_tpu/models/utils/
modules.py``): the flax-semantics BatchNorm, DropPath, conv / linear /
LayerNorm calls that run a module in its input's dtype, and the conv
call of the int8 serving mode.

Training keeps f32 master weights and computes in the input's dtype
(bf16 on the card), as the JAX model with ``compute_dtype`` does:
``conv2d`` and ``linear`` cast the weights per call, and autograd casts
their gradients back to f32. In inference the weights already have the
input's dtype and the casts are no-ops.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.quant import int8_conv
from ...parallel import dist


def conv2d(m: nn.Conv2d, x):
    """``m(x)`` with ``m``'s weights in x's dtype. A map smaller than the
    kernel's reach gives an empty map (0 rows or columns), as XLA's conv
    does (an SSD neck's last levels below its 300^2 input), where torch
    raises."""
    out_hw = [(n + 2 * p - d * (k - 1) - 1) // s + 1 for n, p, d, k, s in zip(
        x.shape[2:], m.padding, m.dilation, m.kernel_size, m.stride)]
    if min(out_hw) <= 0 or min(x.shape[2:]) == 0:
        return x.new_zeros((x.shape[0], m.out_channels)
                           + tuple(max(n, 0) for n in out_hw))
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, m.stride, m.padding,
                    m.dilation, m.groups)


def maybe_int8_conv2d(m: nn.Conv2d, x, int8: bool):
    """``conv2d(m, x)``, or with ``int8`` its int8 serving form
    (``ops.quant.int8_conv``) on the same parameters: the drop-in of the
    JAX ``MaybeInt8Conv``. Dense convs only. A conv over fewer than 16
    input channels (the RGB stem) stays as it is: it has the worst
    relative quantization error and the least to gain."""
    if not int8 or x.shape[1] < 16:
        return conv2d(m, x)
    if m.groups != 1 or m.dilation != (1, 1):
        raise ValueError("maybe_int8_conv2d: dense undilated convs only")
    return int8_conv(x, m.weight, m.bias, m.stride, m.padding)


def linear(m: nn.Linear, x):
    """``m(x)`` with ``m``'s weights in x's dtype."""
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def layer_norm(m: nn.LayerNorm, x):
    """``m(x)`` over the last axis with ``m``'s weights in x's dtype."""
    return F.layer_norm(x, m.normalized_shape, m.weight.to(x.dtype),
                        m.bias.to(x.dtype), m.eps)


class BatchNorm2d(nn.BatchNorm2d):
    """``flax.linen.BatchNorm`` as the JAX ``Norm("bn")`` uses it
    (momentum 0.9 there, which is torch's 0.1). In training it normalizes
    with the batch statistics and moves the running ones toward the
    batch mean and the *biased* batch variance E[x^2] - E[x]^2, both in
    f32 (f64 for an f64 input), as flax does: torch's own update uses the
    unbiased variance, and the running variances would differ after one
    step. In eval it normalizes with the running statistics.

    ``update_stats`` is cleared by ``frozen_stats`` while
    ``torch.utils.checkpoint`` runs a block's forward again for its
    backward, so one step moves the statistics once.

    Under a process group of W > 1 (``parallel/dist.py``) training
    normalizes with the global batch's mean and biased variance, as the
    JAX mesh computes them: the per-channel sums of x and of (x - mean)^2
    are summed over ranks differentiably, so the backward is the global
    batch's too, and the running statistics move toward the global
    values. A recomputed forward issues the same collectives again, in
    the same order on every rank."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if dist.world() > 1:
            return self._global_forward(x)
        y = F.batch_norm(x, None, None, self.weight.to(x.dtype),
                         self.bias.to(x.dtype), True, 0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                dims = (0, 2, 3)
                count = x.numel() // x.shape[1]
                acc = torch.promote_types(x.dtype, torch.float32)
                mean = x.mean(dim=dims, dtype=acc)
                mean2 = torch.linalg.vector_norm(
                    x, 2, dim=dims, dtype=acc).square() / count
                var = (mean2 - mean.square()).clamp(min=0.0)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y

    def _global_forward(self, x):
        dims = (0, 2, 3)
        acc = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(acc)
        count = dist.global_rows(x.numel() // x.shape[1])
        mean = dist.all_reduce_sum(xs.sum(dim=dims)) / count
        d = xs - mean[None, :, None, None]
        var = dist.all_reduce_sum(d.square().sum(dim=dims)) / count
        scale = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        y = d * scale[None, :, None, None] + self.bias.to(acc)[
            None, :, None, None]
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        return y.to(x.dtype)

    def folded_affine(self):
        """The eval-mode norm as an affine ``y = a * x + b`` over the
        channels, ``(a, b)`` in f32 from the running statistics, so a
        fused kernel can apply or absorb it."""
        a = self.weight.float() / torch.sqrt(self.running_var.float()
                                             + self.eps)
        return a, self.bias.float() - self.running_mean.float() * a


@contextlib.contextmanager
def frozen_stats(*norms: BatchNorm2d):
    """Stop ``norms`` from updating their running statistics inside the
    block (a checkpointed forward being recomputed)."""
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class DropPath(nn.Module):
    """Stochastic depth: in training, zero a sample's residual branch
    with probability ``rate`` and scale the kept ones by 1 / (1 - rate).
    The mask comes from torch's global generator, which
    ``torch.utils.checkpoint`` restores for the recomputed forward. Under
    a process group it is drawn at the global batch's shape and cut to
    the rank's rows (``dist.rand_rows``): with every rank's generator
    seeded alike for the step, the ranks drop what one process drops."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = dist.rand_rows(shape, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)
