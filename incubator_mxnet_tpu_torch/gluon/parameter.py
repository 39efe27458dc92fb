"""Gluon parameters (`incubator_mxnet_tpu/gluon/parameter.py`).

A `Parameter` is the gluon-side record of one weight: its full name, its
shape (0 marks a dimension not known yet, resolved at the first forward),
`grad_req`, `lr_mult` and `wd_mult`. Once its shape is known and
`initialize` has been called, it holds a `torch.nn.Parameter` on the
device `initialize` was given, with `requires_grad` set from `grad_req`;
`data()` returns it. A non-differentiable parameter (BatchNorm's running
stats) has `grad_req` "null" and is updated in place by its block.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import initializer as init_mod
from ..config import resolve_device

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(dtype):
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


class DeferredInitializationError(Exception):
    """A parameter was read before its shape was known."""


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._data = None           # torch.nn.Parameter once materialized
        self._deferred_init = None  # (initializer, device) from initialize()

    def __repr__(self):
        return f"Parameter {self.name} (shape={self._shape}, dtype={self.dtype})"

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is not None and not _shape_compatible(self._shape,
                                                             new_shape):
            raise AssertionError(
                f"{self.name}: incompatible shape {new_shape} vs {self._shape}")
        self._shape = tuple(new_shape)
        if self._deferred_init is not None and self._shape_known():
            self._finish_deferred_init()

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    @property
    def grad_req(self):
        return self._grad_req

    def initialize(self, init=None, device=None, default_init=None,
                   force_reinit=False):
        """Initialize with `init`, else the parameter's own `init`, else
        `default_init`, on `device` (None: CUDA, raising without it). With
        the shape still unknown, the draw waits for the first forward."""
        if self._data is not None and not force_reinit:
            return
        if default_init is None:
            default_init = init_mod.Uniform(0.07)
        initializer = init or self.init or default_init
        self._deferred_init = (initializer, resolve_device(device))
        if self._shape_known():
            self._finish_deferred_init()
        elif not self._allow_deferred_init:
            raise ValueError(
                f"cannot initialize {self.name}: shape {self._shape} unknown; "
                "set allow_deferred_init=True or give a full shape")

    def _finish_deferred_init(self):
        initializer, device = self._deferred_init
        arr = torch.zeros(self._shape, dtype=_dtype(self.dtype))
        initializer(init_mod.InitDesc(self.name), arr)
        self._set(arr.to(device))
        self._deferred_init = None

    def _set(self, tensor):
        self._data = torch.nn.Parameter(tensor,
                                        requires_grad=self._grad_req != "null")

    def data(self):
        """The parameter's `torch.nn.Parameter`."""
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred (shape {self._shape})")
            raise RuntimeError(f"parameter {self.name} not initialized")
        return self._data

    def cast(self, dtype):
        """Hold the data (and create later draws) in `dtype`."""
        self.dtype = dtype
        if self._data is not None:
            self._set(self._data.detach().to(_dtype(dtype)))

    def set_data(self, data):
        """Copy `data` into the parameter. An unmaterialized parameter takes
        its shape from `data` and lands on the device `initialize` gave
        it (CUDA when it was never initialized)."""
        data = torch.as_tensor(data)
        if self._data is None:
            device = (self._deferred_init[1] if self._deferred_init
                      else resolve_device(None))
            self._shape = tuple(data.shape)
            self._set(data.to(device=device, dtype=_dtype(self.dtype)).clone())
            self._deferred_init = None
            return
        with torch.no_grad():
            self._data.copy_(data.reshape(self._shape))


def _shape_compatible(old, new):
    if len(old) != len(new):
        return False
    return all(o == n or o in (0, -1) for o, n in zip(old, new))


class ParameterDict:
    """Parameters by full name, in registration order, with a shared
    name prefix."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return f"ParameterDict({list(self._params)})"

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, key):
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """The parameter `prefix + name`, created with `kwargs` if new."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            shape = kwargs.get("shape")
            if shape is not None and param.shape is not None:
                param.shape = tuple(shape)
            return param
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._shared[name]
        param = Parameter(name, **kwargs)
        self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter {k}")
            self._params[k] = v

    def initialize(self, init=None, device=None, force_reinit=False):
        for p in self.values():
            p.initialize(init=None, device=device,
                         default_init=init or init_mod.Uniform(0.07),
                         force_reinit=force_reinit)
