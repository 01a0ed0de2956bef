"""SGD and AdamW with global-norm gradient clipping (counterparts of
``rs_detection_tpu/optims/optimizer.py:SGD`` and ``AdamW``, the optax
chains ``clip_by_global_norm(max_norm)`` -> ``add_decayed_weights`` ->
``sgd`` and ``clip_by_global_norm(max_norm)`` -> ``adamw``).

Both hold one parameter group, clip ahead of each step and count their
steps in ``iterations``, the step the learning-rate schedule reads. Like
the optax chains, they move every parameter whose gradient is a tensor,
zero included (``parallel/train_step.py`` gives a parameter the loss does
not reach a zero gradient, as ``jax.grad`` does)."""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..utils.registry import OPTIMS


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """optax ``clip_by_global_norm``: scale every gradient by
    max_norm / ||g|| when the global norm ||g|| reaches ``max_norm``.
    In place; returns the norm (before clipping), without a host sync."""
    norm = torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(
            g, dtype=torch.promote_types(g.dtype, torch.float32))
        for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def _clip(optimizer, max_norm: Optional[float]) -> None:
    if max_norm is not None:
        params = optimizer.param_groups[0]["params"]
        clip_by_global_norm([p.grad for p in params if p.grad is not None],
                            max_norm)


def _max_norm(grad_clip: Optional[dict]) -> Optional[float]:
    return None if not grad_clip else float(grad_clip.get("max_norm", 35))


@OPTIMS.register_module()
class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` over one parameter group, with optax's
    global-norm clip ahead of each step (``grad_clip=dict(max_norm=...)``,
    None for no clip).

    The optax chain adds ``weight_decay * p`` to the gradient, then keeps
    a trace ``t = g + momentum * t`` that starts at zero (so the first
    trace is the gradient), steps by the trace, or with ``nesterov`` by
    ``g + momentum * t``, times the rate. ``torch.optim.SGD`` with no
    dampening computes the same, its momentum buffer being the trace."""

    STATE_KEYS = ("momentum_buffer",)

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 0.01,
                 momentum: float = 0.9, weight_decay: float = 0.0001,
                 grad_clip: Optional[dict] = None, nesterov: bool = False):
        super().__init__(list(params), lr=lr, momentum=momentum,
                         weight_decay=weight_decay, nesterov=nesterov)
        if len(self.param_groups) != 1:
            raise ValueError("SGD: optax parity needs one parameter group")
        self.max_norm = _max_norm(grad_clip)
        self.iterations = 0

    def step(self, closure=None):
        _clip(self, self.max_norm)
        loss = super().step(closure)
        self.iterations += 1
        return loss


@OPTIMS.register_module()
class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` over one parameter group, with optax's
    global-norm clip ahead of each step (``grad_clip=dict(max_norm=...)``,
    None for no clip).

    optax ``adamw`` decays every leaf, ``p -= lr * wd * p``, with no
    mask; ``torch.optim.AdamW`` applies the same decoupled decay, so the
    two match only with every parameter in a single group and no
    exclusions (no bias or norm carve-outs). ``iterations`` counts the
    steps taken, the step the learning-rate schedule reads."""

    STATE_KEYS = ("step", "exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.05, grad_clip: Optional[dict] = None):
        super().__init__(list(params), lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        if len(self.param_groups) != 1:
            raise ValueError("AdamW: optax parity needs one parameter group")
        self.max_norm = _max_norm(grad_clip)
        self.iterations = 0

    def step(self, closure=None):
        _clip(self, self.max_norm)
        loss = super().step(closure)
        self.iterations += 1
        return loss
