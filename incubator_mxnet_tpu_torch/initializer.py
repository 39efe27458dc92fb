"""Weight initializers, with the JAX package's registry (`register`,
`create`, `dumps`) and name-based dispatch (`incubator_mxnet_tpu/
initializer.py`): Zero, One, Constant, Uniform, Normal, Orthogonal,
Xavier, MSRAPrelu, Bilinear, LSTMBias, FusedRNN, Mixed and Load, also as
the `init` namespace.

An initializer fills a torch tensor in place (`init(desc, arr)`; an
NDArray's tensor too). Random values are drawn from an explicit
`torch.Generator` (the initializer's `generator`, else a CPU generator
seeded from the global random state, `random.next_generator()`, so
`mx.random.seed(s)` fixes the weights) on the generator's device, then
moved to the array's: a seeded CPU generator gives the same weights on
any device. The JAX package draws from JAX keys, so the bits differ from
it; tests compare the distribution, and parity runs carry the weights
across (`gluon.utils.load_numpy_params`). The deterministic initializers
(Constant, Bilinear, LSTMBias, FusedRNN's layout, Mixed, Load) give the
JAX package's values.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from . import random as _random

__all__ = [
    "Initializer", "init", "register", "create", "Zero", "One", "Constant",
    "Uniform", "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
    "LSTMBias", "FusedRNN", "Mixed", "Load", "InitDesc",
]

_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer by name, by its `dumps()` form (a JSON string or the
    parsed [name, kwargs] list), or the initializer itself."""
    if isinstance(name, Initializer):
        return name
    if isinstance(name, (list, tuple)):
        name, kwargs = name[0], {**(name[1] or {}), **kwargs}
    elif isinstance(name, str) and name.startswith("["):
        parsed = json.loads(name)
        name, kwargs = parsed[0], {**(parsed[1] or {}), **kwargs}
    return _REGISTRY[name.lower()](**kwargs)


class InitDesc(str):
    """Name + attrs describing the array being initialized."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _tensor(arr):
    return getattr(arr, "_data", arr)


class Initializer:
    """Base initializer: `init(desc, arr)` fills `arr` in place, by the
    reference's name suffixes (weight, bias, gamma, beta, running and
    moving stats, a fused RNN's parameters); an InitDesc whose attrs
    carry `__init__` (a `dumps()` form) uses that initializer's weight
    rule instead."""

    def __init__(self, generator=None, **kwargs):
        self.generator = generator
        self._kwargs = kwargs

    def dumps(self):
        """[lower-cased class name, constructor kwargs] as JSON."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        arr = _tensor(arr)
        with torch.no_grad():
            if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
                create(desc.attrs["__init__"])._init_weight(desc, arr)
                return
            name = str(desc)
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
            elif name.endswith("parameters") and "rnn" in name:
                self._init_weight(name, arr)
            else:
                self._init_default(name, arr)

    def _generator(self):
        return self.generator or _random.next_generator()

    def _uniform(self, shape, low, high):
        gen = self._generator()
        return torch.empty(shape, device=gen.device).uniform_(
            low, high, generator=gen)

    def _normal(self, shape, std):
        gen = self._generator()
        return torch.empty(shape, device=gen.device).normal_(
            0.0, std, generator=gen)

    @staticmethod
    def _set(arr, value):
        arr.copy_(torch.as_tensor(value).reshape(arr.shape))

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


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


@register
class Constant(Initializer):
    def __init__(self, value=0.0, generator=None):
        super().__init__(generator, value=value)
        self.value = value

    def _init_weight(self, name, arr):
        if np.ndim(self.value):
            self._set(arr, np.asarray(self.value, np.float32))
        else:
            arr.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr.copy_(self._uniform(arr.shape, -self.scale, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr.copy_(self._normal(arr.shape, self.sigma))


@register
class Orthogonal(Initializer):
    """scale times the orthonormal factor (U or V of an SVD) of a uniform
    [-1, 1] or normal (nout, nin) draw."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._uniform((nout, nin), -1.0, 1.0)
        else:
            tmp = self._normal((nout, nin), 1.0)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_(self.scale * q.reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale = sqrt(magnitude / factor), with factor the
    fan-in, fan-out or their mean, fans from an (O, I, *kernel) shape
    times prod(kernel); uniform on [-scale, scale] or normal with std
    scale."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
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


@register
class MSRAPrelu(Xavier):
    """He/MSRA: Gaussian Xavier with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         generator=generator)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a deconvolution weight."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        n = int(np.prod(shape))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        self._set(arr, weight.astype(np.float32))


@register
class LSTMBias(Initializer):
    """Forget-gate bias `forget_bias`, other gates 0 (gate order [i, f, g,
    o]: the second quarter)."""

    def __init__(self, forget_bias=1.0, generator=None):
        super().__init__(generator, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        arr.zero_()
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias

    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The fused RNN op's packed parameter vector: each (layer, direction)
    weight matrix from `init` (default Xavier), the biases zero but LSTM
    forget-gate i2h biases, which get `forget_bias`. The layout is the
    op's (`ops.nn`): weights per (layer, direction), then biases."""

    def __init__(self, init=None, num_hidden=0, num_layers=1, mode="lstm",
                 bidirectional=False, forget_bias=1.0, generator=None):
        super().__init__(generator, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        if isinstance(init, str):
            init = create(init)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, name, arr):
        from .ops.nn import _GATES

        H = self._num_hidden
        D = 2 if self._bidirectional else 1
        G = _GATES[self._mode]
        L = self._num_layers
        n_bias = L * D * 2 * G * H
        n_weight = arr.shape[0] - n_bias
        # each 2-D block through the inner initializer (a flat vector
        # would hit Xavier's 1-D zero fill)
        inner = self._init or Xavier(generator=self.generator)
        inp0 = n_weight // (D * G * H) - (L - 1) * (H * D + H) - H
        blocks = []
        for layer in range(L):
            inp = inp0 if layer == 0 else H * D
            for _ in range(D):
                for shape in ((G * H, inp), (G * H, H)):
                    block = torch.zeros(shape, dtype=arr.dtype)
                    inner._init_weight(name, block)
                    blocks.append(block.reshape(-1))
        weights = torch.cat(blocks)
        assert weights.shape[0] == n_weight, \
            "FusedRNN init walked a different layout than the op"
        biases = torch.zeros(n_bias, dtype=arr.dtype)
        if self._mode == "lstm":
            # per (layer, direction): i2h biases [i f g o], then h2h
            for blk in range(L * D):
                start = blk * 2 * G * H + H
                biases[start:start + H] = self._forget_bias
        arr.copy_(torch.cat([weights, biases]).to(arr.device))

    _init_bias = _init_weight


@register
class Mixed(Initializer):
    """The first initializer whose pattern matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, i in self.map:
            if prog.match(str(name)):
                i(name, arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")


@register
class Load:
    """Initialize from a dict of arrays ("arg:" / "aux:" prefixes
    dropped), falling back to `default_init`."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        if name in self.param:
            value = self.param[name]
            if hasattr(value, "asnumpy"):
                value = value.asnumpy()
            elif torch.is_tensor(value):
                value = value.detach().cpu()
            with torch.no_grad():
                _tensor(arr).copy_(torch.as_tensor(np.asarray(value))
                                   .reshape(_tensor(arr).shape))
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError(f"no init for {name}")


class init:
    """Namespace alias so `mx.init.Xavier()` works like the reference."""

    Zero = Zero
    One = One
    Constant = Constant
    Uniform = Uniform
    Normal = Normal
    Orthogonal = Orthogonal
    Xavier = Xavier
    MSRAPrelu = MSRAPrelu
    Bilinear = Bilinear
    LSTMBias = LSTMBias
    FusedRNN = FusedRNN
    Mixed = Mixed
    Load = Load
    Initializer = Initializer
    InitDesc = InitDesc
