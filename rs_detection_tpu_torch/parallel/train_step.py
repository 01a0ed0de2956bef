"""The training step and the eval step (counterparts of
``rs_detection_tpu/parallel/train_step.py:make_train_step`` and
``make_eval_step``), on one device or data-parallel over a process group
(``parallel/dist.py``: one process a card, NCCL, or gloo on the CPU),
with the per-step EMA of the parameters (``ParamEMA``).

Under a group of W processes each rank holds its rows of the global
batch and the step computes what one process computes on the global
batch, as the JAX mesh does: BatchNorm normalizes with the global
statistics, DropPath and the samplers draw at the global batch's shape,
a loss normalized by a count divides by the global count (the layers'
own doing, through ``dist``), and the gradients are averaged over ranks
in one flat all-reduce a dtype after the backward, before the clip. No
``DistributedDataParallel``: the model's entry point is ``loss``, not
``forward``, and the frozen stages' parameters get the zero gradient of
``zero_missing_grads`` on every rank before the average, so one
collective after the backward covers every parameter."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch

from . import dist


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
    ``TrainState.step``).

    Under a process group ``images`` and ``targets`` are the rank's rows
    and every rank's ``generator`` (and torch's global generator, which
    DropPath reads) must be seeded alike; the gradients are averaged over
    ranks before the optimizer's clip, so every rank takes the same step
    and moves the same EMA, and the returned losses are the global
    batch's (the ranks' mean)."""
    model.train()
    lr = scheduler(optimizer.defaults["lr"], optimizer.iterations, epoch)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    losses = model.loss(images, targets, generator)
    total = sum(v for k, v in losses.items() if "loss" in k)
    total.backward()
    zero_missing_grads(optimizer)
    dist.all_reduce_mean_([p.grad for group in optimizer.param_groups
                           for p in group["params"]])
    optimizer.step()
    if ema is not None:
        ema.update(step)
    out = {k: v.detach() for k, v in losses.items()}
    out["total_loss"] = total.detach()
    return global_values(out)


def global_values(values: Dict[str, torch.Tensor]) -> Dict:
    """Scalars averaged over ranks, in one collective (the identity
    without a group)."""
    if dist.world() == 1:
        return values
    keys = list(values)
    flat = torch.stack([values[k].float() for k in keys])
    dist.all_reduce_mean_([flat])
    return {k: flat[i].to(values[k].dtype) for i, k in enumerate(keys)}


def make_eval_step(model):
    """The eval step: ``step(images, scale_factor) -> dense outputs`` of
    ``model.predict`` on a global batch (images NHWC on the rank's
    device, ``scale_factor`` [B]). Without a group it is ``predict``.
    Under a group of W each rank runs ``predict`` on its rows and every
    rank gets the outputs gathered in batch order; a batch that W does
    not divide is padded with copies of its last image up to the next
    multiple and the outputs trimmed back, so they equal one process's
    (JAX instead runs such a batch on one device)."""

    @torch.no_grad()
    def step(images, scale_factor=None):
        w = dist.world()
        if w == 1:
            return model.predict(images, scale_factor)
        b = images.shape[0]

        def mine(x):
            if x is None:
                return None
            pad = -b % w
            if pad:
                x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
            return dist.rows(x)

        out = model.predict(mine(images), mine(scale_factor))
        gathered = {}
        for k, v in out.items():
            # gloo gathers no bool: through uint8 and back
            g = dist.all_gather_rows(v.to(torch.uint8) if v.dtype ==
                                     torch.bool else v)
            gathered[k] = (g.bool() if v.dtype == torch.bool else g)[:b]
        return gathered

    return step
