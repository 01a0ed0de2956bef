"""One training step on one device (counterpart of the step function of
``rs_detection_tpu/parallel/train_step.py:make_train_step``, without its
mesh and EMA)."""

from __future__ import annotations

from typing import Dict

import torch


def zero_missing_grads(optimizer) -> None:
    """A zero gradient for every parameter of ``optimizer`` that the
    backward did not reach."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def train_step(model, optimizer, scheduler, images, targets, generator,
               epoch: float) -> Dict:
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
    does."""
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
    out = {k: v.detach() for k, v in losses.items()}
    out["total_loss"] = total.detach()
    return out
