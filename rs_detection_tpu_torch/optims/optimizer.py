"""SGD, AdamW, Adam and GradMutilpySGD with global-norm gradient
clipping (counterparts of ``rs_detection_tpu/optims/optimizer.py:SGD``,
``AdamW``, ``Adam`` and ``GradMutilpySGD``, the optax chains
``clip_by_global_norm(max_norm)`` -> ``add_decayed_weights`` -> ``sgd``,
``clip_by_global_norm(max_norm)`` -> ``adamw``,
``clip_by_global_norm(max_norm)`` -> [``add_decayed_weights`` ->]
``adam``, and ``clip_by_global_norm(max_norm)`` -> the per-name gradient
multipliers -> ``add_decayed_weights`` -> ``sgd``).

Each holds one parameter group, clips ahead of each step and counts its
steps in ``iterations``, the step the learning-rate schedule reads. Like
the optax chains, they move every parameter whose gradient is a tensor,
zero included (``parallel/train_step.py`` gives a parameter the loss does
not reach a zero gradient, as ``jax.grad`` does). ``params`` may be
``(name, parameter)`` pairs (``named_parameters()``); the names are what
the gradient multipliers and the parameter-group generators read.

A parameter-group generator (``models/param_generators.py``) links its
masked transforms around the chain, as the JAX generators chain optax
links around ``tx``: ``grad_links`` run on the gradients before the clip,
and the parameters in ``frozen`` keep their values through the step
(optax ``set_to_zero`` after the chain)."""

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


def _named(params):
    """``params`` as (names or None, parameters): a list of tensors has no
    names, a list of ``(name, tensor)`` pairs has."""
    params = list(params)
    if params and isinstance(params[0], tuple):
        return [n for n, _ in params], [p for _, p in params]
    return None, params


class _Linked:
    """What the optimizers share: the names, the generator's links and
    the step as the optax chain takes it (links, clip, the optimizer's
    own gradient transform, its update, frozen parameters restored)."""

    def _init_links(self, names, grad_clip):
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__}: optax parity needs one "
                             f"parameter group")
        self.param_names = names
        self.max_norm = _max_norm(grad_clip)
        self.iterations = 0
        self.grad_links = []
        self.frozen = []

    def named_params(self):
        """(name, parameter) pairs of the group; raises without names."""
        if self.param_names is None:
            raise ValueError(f"{type(self).__name__}: built without "
                             f"parameter names; pass named_parameters()")
        return list(zip(self.param_names, self.param_groups[0]["params"]))

    def _scale_grads(self):
        """The optimizer's own link between the clip and the update."""

    @torch.no_grad()
    def step(self, closure=None):
        for link in self.grad_links:
            link()
        _clip(self, self.max_norm)
        self._scale_grads()
        kept = [p.detach().clone() for p in self.frozen]
        loss = super().step(closure)
        for p, k in zip(self.frozen, kept):
            p.copy_(k)
        self.iterations += 1
        return loss


@OPTIMS.register_module()
class SGD(_Linked, torch.optim.SGD):
    """``torch.optim.SGD`` over one parameter group, with optax's
    global-norm clip ahead of each step (``grad_clip=dict(max_norm=...)``,
    None for no clip).

    The optax chain adds ``weight_decay * p`` to the gradient, then keeps
    a trace ``t = g + momentum * t`` that starts at zero (so the first
    trace is the gradient), steps by the trace, or with ``nesterov`` by
    ``g + momentum * t``, times the rate. ``torch.optim.SGD`` with no
    dampening computes the same, its momentum buffer being the trace."""

    STATE_KEYS = ("momentum_buffer",)

    def __init__(self, params: Iterable, lr: float = 0.01,
                 momentum: float = 0.9, weight_decay: float = 0.0001,
                 grad_clip: Optional[dict] = None, nesterov: bool = False):
        names, params = _named(params)
        super().__init__(params, lr=lr, momentum=momentum,
                         weight_decay=weight_decay, nesterov=nesterov)
        self._init_links(names, grad_clip)


@OPTIMS.register_module()
class AdamW(_Linked, torch.optim.AdamW):
    """``torch.optim.AdamW`` over one parameter group, with optax's
    global-norm clip ahead of each step (``grad_clip=dict(max_norm=...)``,
    None for no clip).

    optax ``adamw`` decays every leaf, ``p -= lr * wd * p``, with no
    mask; ``torch.optim.AdamW`` applies the same decoupled decay, so the
    two match only with every parameter in a single group and no
    exclusions (no bias or norm carve-outs). ``iterations`` counts the
    steps taken, the step the learning-rate schedule reads."""

    STATE_KEYS = ("step", "exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable, lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.05, grad_clip: Optional[dict] = None):
        names, params = _named(params)
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self._init_links(names, grad_clip)


@OPTIMS.register_module()
class Adam(_Linked, torch.optim.Adam):
    """``torch.optim.Adam`` over one parameter group, with optax's
    global-norm clip ahead of each step (``grad_clip=dict(max_norm=...)``,
    None for no clip).

    The weight decay is added to the (clipped) gradient before the Adam
    moments, ``g + weight_decay * p`` (optax ``add_decayed_weights`` ->
    ``adam``), not decoupled as in ``AdamW``: ``torch.optim.Adam``'s
    ``weight_decay`` is that coupled form."""

    STATE_KEYS = ("step", "exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: Optional[dict] = None):
        names, params = _named(params)
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay)
        self._init_links(names, grad_clip)


@OPTIMS.register_module()
class GradMutilpySGD(SGD):
    """SGD with per-name gradient multipliers (reference
    ``optimizer.py:46``; the spelling is the reference's): after the clip,
    a gradient whose parameter name contains a key of ``multipliers`` is
    scaled by that key's factor (the first key that matches, in the
    dict's order), then decayed and stepped as ``SGD``. The JAX link
    matches the keys against the flax path (``['params']/['_backbone']/
    ...``), the port against the state_dict name (``backbone....``): a
    key that names a module (``backbone``, ``retina_cls``) matches the
    same parameters in both. No config of the repository sets
    ``multipliers``."""

    def __init__(self, params: Iterable, lr: float = 0.01,
                 momentum: float = 0.9, weight_decay: float = 0.0001,
                 grad_clip: Optional[dict] = None, multipliers=None):
        super().__init__(params, lr=lr, momentum=momentum,
                         weight_decay=weight_decay, grad_clip=grad_clip)
        self._factors = []
        for name, p in (self.named_params() if multipliers else ()):
            factor = next((v for k, v in multipliers.items() if k in name),
                          1.0)
            if factor != 1.0:
                self._factors.append((p, factor))

    def _scale_grads(self):
        for p, factor in self._factors:
            if p.grad is not None:
                p.grad.mul_(factor)
