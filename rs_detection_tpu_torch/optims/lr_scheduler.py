"""Learning-rate schedule (counterpart of
``rs_detection_tpu/optims/lr_scheduler.py:StepLR``): per-iteration warmup
times per-epoch milestone decay, as a pure function of (step, epoch)."""

from __future__ import annotations

from typing import Optional, Sequence


def warmup_factor(step: int, warmup: Optional[str], warmup_iters: int,
                  warmup_ratio: float) -> float:
    """Per-iteration linear warmup factor, from ``warmup_ratio`` up to 1
    over ``warmup_iters`` iterations (1 when ``warmup`` is None)."""
    if warmup is None or warmup_iters <= 0:
        return 1.0
    t = min(max(step / warmup_iters, 0.0), 1.0)
    return 1.0 - (1.0 - t) * (1.0 - warmup_ratio)


class StepLR:
    """Decay by ``gamma`` at each epoch milestone, times the warmup.
    Only the linear warmup is ported: every config of the repository
    that sets a warmup sets "linear"."""

    def __init__(self, milestones: Sequence[int], gamma: float = 0.1,
                 warmup: Optional[str] = None, warmup_iters: int = 0,
                 warmup_ratio: float = 1.0 / 3):
        if warmup not in (None, "linear"):
            raise NotImplementedError(f"StepLR: warmup {warmup!r} is not "
                                      f"ported, only 'linear'")
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.warmup = warmup
        self.warmup_iters = warmup_iters
        self.warmup_ratio = warmup_ratio

    def __call__(self, base_lr: float, step: int, epoch: int) -> float:
        n = sum(1 for m in self.milestones if epoch >= m)
        return base_lr * self.gamma ** n * warmup_factor(
            step, self.warmup, self.warmup_iters, self.warmup_ratio)
