"""Learning-rate schedules (counterparts of every schedule of
``rs_detection_tpu/optims/lr_scheduler.py``: ``StepLR``,
``CosineAnnealingLR``, ``CosineAnnealingLRGroup``, ``ExpLR``, ``PolyLR``,
``InvLR``, ``WarmUpLR`` and ``WarmUpLRGroup``): a per-iteration warmup
("constant", "linear" or "exp") times a per-epoch (``InvLR``: per-step)
decay, as pure functions of (step, epoch)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from ..utils.registry import SCHEDULERS


def warmup_factor(step: int, warmup: Optional[str], warmup_iters: int,
                  warmup_ratio: float) -> float:
    """Per-iteration warmup factor over the first ``warmup_iters``
    iterations, 1 after them (and when ``warmup`` is None): "constant"
    holds ``warmup_ratio``, "linear" rises from it to 1, "exp" is
    ``warmup_ratio ** (1 - t)``, t the fraction of the warmup done."""
    if warmup is None or warmup_iters <= 0:
        return 1.0
    t = min(max(step / warmup_iters, 0.0), 1.0)
    if warmup == "constant":
        f = warmup_ratio
    elif warmup == "linear":
        f = 1.0 - (1.0 - t) * (1.0 - warmup_ratio)
    elif warmup == "exp":
        f = warmup_ratio ** (1.0 - t)
    else:
        raise ValueError(warmup)
    return f if t < 1.0 else 1.0


class _Warmed:
    """The warmup that every schedule multiplies its decay by."""

    def _init_warmup(self, warmup, warmup_iters, warmup_ratio):
        self.warmup = warmup
        self.warmup_iters = warmup_iters
        self.warmup_ratio = warmup_ratio

    def _warm(self, lr, step):
        return lr * warmup_factor(step, self.warmup, self.warmup_iters,
                                  self.warmup_ratio)


@SCHEDULERS.register_module()
class StepLR(_Warmed):
    """Decay by ``gamma`` at each epoch milestone, times the warmup. Other
    keys are accepted and ignored, as in the JAX package."""

    def __init__(self, milestones: Sequence[int], gamma: float = 0.1,
                 warmup: Optional[str] = None, warmup_iters: int = 0,
                 warmup_ratio: float = 1.0 / 3, **_):
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self._init_warmup(warmup, warmup_iters, warmup_ratio)

    def __call__(self, base_lr: float, step: int, epoch: int) -> float:
        n = sum(1 for m in self.milestones if epoch >= m)
        return self._warm(base_lr * self.gamma ** n, step)


@SCHEDULERS.register_module()
class CosineAnnealingLR(_Warmed):
    """Cosine decay by epoch from 1 to ``min_lr_ratio`` of the base rate
    over ``max_steps`` epochs, times the warmup (the SWA schedule of the
    flagship configs). Other keys are accepted and ignored, as in the JAX
    package: a config's ``min_lr`` leaves ``min_lr_ratio`` at 0."""

    def __init__(self, max_steps: int = 1, min_lr_ratio: float = 0.0,
                 warmup: Optional[str] = None, warmup_iters: int = 0,
                 warmup_ratio: float = 1.0 / 3, **_):
        self.max_steps = max_steps
        self.min_lr_ratio = min_lr_ratio
        self._init_warmup(warmup, warmup_iters, warmup_ratio)

    def __call__(self, base_lr: float, step: int, epoch: float) -> float:
        t = min(max(epoch / self.max_steps, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        lr = base_lr * (self.min_lr_ratio + (1.0 - self.min_lr_ratio) * cos)
        return self._warm(lr, step)


@SCHEDULERS.register_module()
class CosineAnnealingLRGroup(CosineAnnealingLR):
    """The YOLO recipes' schedule, as JAX's: ``CosineAnnealingLR`` (by
    epoch over ``max_steps``, ``min_lr_ratio`` 0.2 by default) times the
    warmup. ``max_steps`` (or ``max_epoch``) is required: without it the
    cosine would fall to its floor after the first epoch. The reference's
    per-group warmups (``warmup_init_lr_pg``) and the momentum warmup
    (``warmup_initial_momentum``) are recorded and applied to nothing,
    as in JAX."""

    def __init__(self, warmup_init_lr_pg=None, warmup_initial_momentum=None,
                 min_lr_ratio: float = 0.2, **kw):
        max_epoch = kw.pop("max_epoch", None)
        if "max_steps" not in kw:
            if not max_epoch:
                raise TypeError("CosineAnnealingLRGroup requires max_steps "
                                "(or max_epoch), as in the reference")
            kw["max_steps"] = max_epoch
        super().__init__(min_lr_ratio=min_lr_ratio, **kw)
        self.warmup_init_lr_pg = warmup_init_lr_pg
        self.warmup_initial_momentum = warmup_initial_momentum


@SCHEDULERS.register_module()
class ExpLR(_Warmed):
    """``base_lr * gamma ** epoch``, times the warmup."""

    def __init__(self, gamma: float = 0.9, warmup: Optional[str] = None,
                 warmup_iters: int = 0, warmup_ratio: float = 1.0 / 3, **_):
        self.gamma = gamma
        self._init_warmup(warmup, warmup_iters, warmup_ratio)

    def __call__(self, base_lr: float, step: int, epoch: float) -> float:
        return self._warm(base_lr * self.gamma ** epoch, step)


@SCHEDULERS.register_module()
class PolyLR(_Warmed):
    """``(base_lr - min_lr) * (1 - t) ** power + min_lr``, t the epoch
    over ``max_steps`` clipped to [0, 1], times the warmup."""

    def __init__(self, max_steps: int = 1, power: float = 0.9,
                 min_lr: float = 0.0, warmup: Optional[str] = None,
                 warmup_iters: int = 0, warmup_ratio: float = 1.0 / 3, **_):
        self.max_steps = max_steps
        self.power = power
        self.min_lr = min_lr
        self._init_warmup(warmup, warmup_iters, warmup_ratio)

    def __call__(self, base_lr: float, step: int, epoch: float) -> float:
        t = min(max(epoch / self.max_steps, 0.0), 1.0)
        lr = (base_lr - self.min_lr) * (1.0 - t) ** self.power + self.min_lr
        return self._warm(lr, step)


@SCHEDULERS.register_module()
class InvLR(_Warmed):
    """``base_lr * (1 + gamma * step) ** -power`` (by step, not epoch),
    times the warmup."""

    def __init__(self, gamma: float = 0.1, power: float = 0.75,
                 warmup: Optional[str] = None, warmup_iters: int = 0,
                 warmup_ratio: float = 1.0 / 3, **_):
        self.gamma = gamma
        self.power = power
        self._init_warmup(warmup, warmup_iters, warmup_ratio)

    def __call__(self, base_lr: float, step: int, epoch: float) -> float:
        return self._warm(base_lr * (1.0 + self.gamma * step) ** -self.power,
                          step)


@SCHEDULERS.register_module()
class WarmUpLR(StepLR):
    """The warmup alone (a ``StepLR`` without milestones); "linear" over
    500 iterations by default."""

    def __init__(self, warmup: Optional[str] = "linear",
                 warmup_iters: int = 500, warmup_ratio: float = 1.0 / 3, **_):
        super().__init__(milestones=[], warmup=warmup,
                         warmup_iters=warmup_iters, warmup_ratio=warmup_ratio)


@SCHEDULERS.register_module()
class WarmUpLRGroup(WarmUpLR):
    """The reference's per-group warmup: one warmup for the whole
    parameter set, as in JAX (the groups' scales are the optimizer's)."""
