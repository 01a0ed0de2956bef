"""One training step on one device (counterpart of the step function of
``rs_detection_tpu/parallel/train_step.py:make_train_step``, without its
mesh), with the per-step EMA of the parameters (``ParamEMA``)."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch


class ParamEMA:
    """Per-step exponential moving average of a module's parameters (not
    its buffers), the JAX ``TrainState.ema_params``: after step ``step``
    (the count before it, from 0) ``e = d * e + (1 - d) * p`` with
    ``d = decay * (1 - exp(-(step + 1) / ramp))``. The average starts as
    a copy of the parameters, in their dtype and on their device;
    ``update`` is one ``_foreach`` pass under ``no_grad`` with no host
    sync. ``names`` are the parameters' names, ``shadow`` the averages in
    that order."""

    def __init__(self, model: torch.nn.Module, decay: float = 0.9999,
                 ramp: float = 2000.0):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.shadow = [p.detach().clone() for p in self.params]
        self.decay, self.ramp = decay, ramp

    @torch.no_grad()
    def update(self, step: int) -> None:
        d = self.decay * (1.0 - math.exp(-(step + 1.0) / self.ramp))
        torch._foreach_mul_(self.shadow, d)
        torch._foreach_add_(self.shadow, [p.detach() for p in self.params],
                            alpha=1.0 - d)

    def _swap(self) -> None:
        for i, p in enumerate(self.params):
            p.data, self.shadow[i] = self.shadow[i], p.data

    @contextlib.contextmanager
    def applied(self):
        """The module's parameters hold the averages inside the block and
        their own values again after it (the tensors are exchanged, not
        copied)."""
        self._swap()
        try:
            yield
        finally:
            self._swap()


def zero_missing_grads(optimizer) -> None:
    """A zero gradient for every parameter of ``optimizer`` that the
    backward did not reach."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def train_step(model, optimizer, scheduler, images, targets, generator,
               epoch: float, ema: Optional[ParamEMA] = None,
               step: int = 0) -> Dict:
    """``model.loss`` -> backward -> ``optimizer.step`` at the scheduled
    learning rate. ``optimizer`` is one of ``optims.optimizer`` (one
    parameter group, its step count in ``iterations``); its base learning
    rate and step count feed ``scheduler(base_lr, step, epoch)``.
    ``epoch`` is the optimizer's own count in epochs (its ``iterations``
    over the steps per epoch, as the JAX runner's schedule reads it; a
    fresh optimizer restarts it), required: a wrong or missing one
    silently moves every StepLR milestone. Returns the detached losses
    and "total_loss", the sum of the entries named "loss", which is what
    is differentiated. The BN running statistics move once, in the
    forward. A parameter the loss does not reach (a frozen ResNet stage,
    cut by ``detach``) gets a zero gradient, as ``jax.grad`` gives it, so
    the optimizer decays it and runs its momentum as the optax chain
    does. With ``ema``, the average moves after the optimizer's step,
    ``step`` being the run's step count before this one (the JAX
    ``TrainState.step``)."""
    model.train()
    lr = scheduler(optimizer.defaults["lr"], optimizer.iterations, epoch)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    losses = model.loss(images, targets, generator)
    total = sum(v for k, v in losses.items() if "loss" in k)
    total.backward()
    zero_missing_grads(optimizer)
    optimizer.step()
    if ema is not None:
        ema.update(step)
    out = {k: v.detach() for k, v in losses.items()}
    out["total_loss"] = total.detach()
    return out
