"""AdamW with global-norm gradient clipping (counterpart of
``rs_detection_tpu/optims/optimizer.py:AdamW``, the optax chain
``clip_by_global_norm(max_norm)`` -> ``adamw``)."""

from __future__ import annotations

from typing import Iterable, Optional

import torch


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """optax ``clip_by_global_norm``: scale every gradient by
    max_norm / ||g|| when the global norm ||g|| reaches ``max_norm``.
    In place; returns the norm (before clipping), without a host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                     for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` over one parameter group, with optax's
    global-norm clip ahead of each step (``grad_clip=dict(max_norm=...)``,
    None for no clip).

    optax ``adamw`` decays every leaf, ``p -= lr * wd * p``, with no
    mask; ``torch.optim.AdamW`` applies the same decoupled decay, so the
    two match only with every parameter in a single group and no
    exclusions (no bias or norm carve-outs). ``iterations`` counts the
    steps taken, the step the learning-rate schedule reads."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.05, grad_clip: Optional[dict] = None):
        super().__init__(list(params), lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        if len(self.param_groups) != 1:
            raise ValueError("AdamW: optax parity needs one parameter group")
        self.max_norm = None if not grad_clip else \
            float(grad_clip.get("max_norm", 35))
        self.iterations = 0

    def step(self, closure=None):
        if self.max_norm is not None:
            grads = [p.grad for p in self.param_groups[0]["params"]
                     if p.grad is not None]
            clip_by_global_norm(grads, self.max_norm)
        loss = super().step(closure)
        self.iterations += 1
        return loss
