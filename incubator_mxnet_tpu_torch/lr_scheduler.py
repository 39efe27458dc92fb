"""Learning-rate schedules (`incubator_mxnet_tpu/lr_scheduler.py`, the
port's own copy): every schedule is a stateless closed-form function of
`num_update`, the warmup ramp and the decay law composed in `__call__`,
each subclass contributing its decay formula. Plain Python, so a
schedule gives the same rates in both packages, and a train step hands
each step's rate to the device as a float32 tensor.
"""
from __future__ import annotations

import bisect
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base: linear/quadratic warmup from warmup_begin_lr to base_lr over
    warmup_steps, then the subclass decay law."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        t = num_update / self.warmup_steps
        if self.warmup_mode == "linear":
            return self.warmup_begin_lr + (self.warmup_final_lr
                                           - self.warmup_begin_lr) * t
        return self.warmup_final_lr * t * t

    def _decay(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decay(num_update)


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^(number of `step`-sized intervals completed),
    floored at stop_factor_lr (ref: FactorScheduler)."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _decay(self, num_update):
        n = max(0, (num_update - 1) // self.step)
        return max(self.base_lr * self.factor ** n, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr = base_lr * factor^(number of milestones passed)
    (ref: MultiFactorScheduler)."""

    def __init__(self, step, factor=1.0, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = sorted(step)
        self.factor = factor

    def _decay(self, num_update):
        # milestone m is passed once num_update > m
        n = bisect.bisect_left(self.step, num_update)
        return self.base_lr * self.factor ** n


class _AnnealToFinal(LRScheduler):
    """Shared shape for poly/cosine: interpolate base_lr -> final_lr over
    [warmup_steps, max_update] by a profile of the progress fraction."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def _profile(self, frac):
        raise NotImplementedError

    def _decay(self, num_update):
        if num_update > self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return self.final_lr + (self.base_lr - self.final_lr) * self._profile(frac)


class PolyScheduler(_AnnealToFinal):
    """Polynomial decay profile (1 - frac)^pwr (ref: PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, **kw):
        super().__init__(max_update, base_lr, final_lr, **kw)
        self.power = pwr

    def _profile(self, frac):
        return (1 - frac) ** self.power


class CosineScheduler(_AnnealToFinal):
    """Half-cosine decay profile (1 + cos(pi frac)) / 2
    (ref: CosineScheduler)."""

    def _profile(self, frac):
        return (1 + math.cos(math.pi * frac)) / 2
