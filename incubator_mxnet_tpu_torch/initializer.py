"""Weight initializers, with the JAX package's name-based dispatch
(`incubator_mxnet_tpu/initializer.py`).

Values are drawn from an explicit `torch.Generator` (the initializer's
`generator`, else PyTorch's default CPU generator) on the generator's
device, then moved to the parameter's: a seeded CPU generator gives the
same weights on any device. The JAX package draws from JAX keys, so the
bits differ from it; tests compare the distribution, and parity runs
carry the weights across (`gluon.utils.load_numpy_params`).
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Uniform", "Xavier"]


class InitDesc(str):
    """Name + attrs describing the array being initialized."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


class Initializer:
    """Base initializer: `init(name, arr)` fills `arr` in place, by the
    reference's name suffixes (weight, bias, gamma, beta, running and
    moving stats)."""

    def __init__(self, generator=None):
        self.generator = generator

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        name = str(desc)
        with torch.no_grad():
            if name.endswith("weight"):
                self._init_weight(name, arr)
            elif name.endswith("bias"):
                self._init_bias(name, arr)
            elif name.endswith("gamma"):
                self._init_gamma(name, arr)
            elif name.endswith("beta"):
                self._init_beta(name, arr)
            elif name.endswith(("moving_mean", "running_mean")):
                self._init_zero(name, arr)
            elif name.endswith(("moving_var", "running_var")):
                self._init_one(name, arr)
            elif name.endswith(("min", "max")):
                self._init_zero(name, arr)
            else:
                self._init_default(name, arr)

    def _uniform(self, shape, low, high):
        gen = self.generator or torch.default_generator
        return torch.empty(shape, device=gen.device).uniform_(
            low, high, generator=gen)

    def _normal(self, shape, std):
        gen = self.generator or torch.default_generator
        return torch.empty(shape, device=gen.device).normal_(
            0.0, std, generator=gen)

    def _init_zero(self, name, arr):
        arr.zero_()

    def _init_one(self, name, arr):
        arr.fill_(1.0)

    def _init_bias(self, name, arr):
        self._init_zero(name, arr)

    def _init_gamma(self, name, arr):
        self._init_one(name, arr)

    def _init_beta(self, name, arr):
        self._init_zero(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        self._init_weight(name, arr)


class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


class Uniform(Initializer):
    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr.copy_(self._uniform(arr.shape, -self.scale, self.scale))


class Xavier(Initializer):
    """Xavier/Glorot: scale = sqrt(magnitude / factor), with factor the
    fan-in, fan-out or their mean, fans from an (O, I, *kernel) shape
    times prod(kernel); uniform on [-scale, scale] or normal with std
    scale."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def bound(self, shape):
        """The scale for an array of `shape` (None below two dims)."""
        if len(shape) < 2:
            return None
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr):
        scale = self.bound(tuple(arr.shape))
        if scale is None:
            self._init_zero(name, arr)
        elif self.rnd_type == "uniform":
            arr.copy_(self._uniform(arr.shape, -scale, scale))
        else:
            arr.copy_(self._normal(arr.shape, scale))
