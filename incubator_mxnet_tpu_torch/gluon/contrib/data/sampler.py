"""Contrib samplers (`incubator_mxnet_tpu/gluon/contrib/data/sampler.py`,
the JAX package's module as it is: it is pure Python)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Visit [0, length) at a fixed stride, rolling through the offsets
    (IntervalSampler(13, 3) yields 0,3,6,9,12,1,4,7,10,2,5,8,11)."""

    def __init__(self, length, interval, rollover=True):
        if not 0 < interval <= length:
            raise ValueError(
                f"interval {interval} must be in [1, length={length}]")
        self._length = int(length)
        self._interval = int(interval)
        self._rollover = bool(rollover)

    def __iter__(self):
        offsets = range(self._interval) if self._rollover else [0]
        for start in offsets:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
