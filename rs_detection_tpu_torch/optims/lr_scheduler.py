"""Learning-rate schedules (counterparts of
``rs_detection_tpu/optims/lr_scheduler.py:StepLR``, ``CosineAnnealingLR``
and ``CosineAnnealingLRGroup``): a per-iteration warmup times a
per-epoch decay, as pure functions of (step, epoch)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from ..utils.registry import SCHEDULERS


def warmup_factor(step: int, warmup: Optional[str], warmup_iters: int,
                  warmup_ratio: float) -> float:
    """Per-iteration linear warmup factor, from ``warmup_ratio`` up to 1
    over ``warmup_iters`` iterations (1 when ``warmup`` is None)."""
    if warmup is None or warmup_iters <= 0:
        return 1.0
    t = min(max(step / warmup_iters, 0.0), 1.0)
    return 1.0 - (1.0 - t) * (1.0 - warmup_ratio)


def _check_warmup(name: str, warmup: Optional[str]) -> None:
    if warmup not in (None, "linear"):
        raise NotImplementedError(f"{name}: warmup {warmup!r} is not "
                                  f"ported, only 'linear'")


@SCHEDULERS.register_module()
class StepLR:
    """Decay by ``gamma`` at each epoch milestone, times the warmup.
    Only the linear warmup is ported: every config of the repository
    that sets a warmup sets "linear"."""

    def __init__(self, milestones: Sequence[int], gamma: float = 0.1,
                 warmup: Optional[str] = None, warmup_iters: int = 0,
                 warmup_ratio: float = 1.0 / 3):
        _check_warmup("StepLR", warmup)
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.warmup = warmup
        self.warmup_iters = warmup_iters
        self.warmup_ratio = warmup_ratio

    def __call__(self, base_lr: float, step: int, epoch: int) -> float:
        n = sum(1 for m in self.milestones if epoch >= m)
        return base_lr * self.gamma ** n * warmup_factor(
            step, self.warmup, self.warmup_iters, self.warmup_ratio)


@SCHEDULERS.register_module()
class CosineAnnealingLR:
    """Cosine decay by epoch from 1 to ``min_lr_ratio`` of the base rate
    over ``max_steps`` epochs, times the warmup (the SWA schedule of the
    flagship configs). Other keys are accepted and ignored, as in the JAX
    package: a config's ``min_lr`` leaves ``min_lr_ratio`` at 0."""

    def __init__(self, max_steps: int = 1, min_lr_ratio: float = 0.0,
                 warmup: Optional[str] = None, warmup_iters: int = 0,
                 warmup_ratio: float = 1.0 / 3, **_):
        _check_warmup("CosineAnnealingLR", warmup)
        self.max_steps = max_steps
        self.min_lr_ratio = min_lr_ratio
        self.warmup = warmup
        self.warmup_iters = warmup_iters
        self.warmup_ratio = warmup_ratio

    def __call__(self, base_lr: float, step: int, epoch: float) -> float:
        t = min(max(epoch / self.max_steps, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        lr = base_lr * (self.min_lr_ratio + (1.0 - self.min_lr_ratio) * cos)
        return lr * warmup_factor(step, self.warmup, self.warmup_iters,
                                  self.warmup_ratio)


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
