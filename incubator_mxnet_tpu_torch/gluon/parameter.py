"""Gluon parameters (`incubator_mxnet_tpu/gluon/parameter.py`).

A `Parameter` is the gluon-side record of one weight: its full name, its
shape (0 marks a dimension not known yet, resolved at the first forward),
`grad_req`, `lr_mult` and `wd_mult`. Once its shape is known and
`initialize` has been called, it holds a `torch.nn.Parameter` on the
device `initialize` was given, with `requires_grad` set from `grad_req`,
wrapped in one NDArray that is an autograd variable with a gradient
buffer. `data()` and `grad()` return those NDArrays, as in the JAX
package; `tensor()` returns the `torch.nn.Parameter` itself, or, inside
`block._ParamSubst`, the tensor the substitution maps its name to (a
train step's compute-dtype copy). A non-differentiable parameter
(BatchNorm's running stats) has `grad_req` "null" and is updated by its
block.

`cast` rebinds the data to a new `torch.nn.Parameter` (in the same
NDArray): a holder of the old tensor (a train step built before the
cast) no longer sees it.

A parameter with `grad_stype="row_sparse"` (an embedding table) starts
with an empty `RowSparseNDArray` gradient instead of a table-sized zero
buffer; `autograd.backward` replaces it with the rows a batch touched
(or a dense gradient, when the table is used densely), and `zero_grad`
empties it again.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from .. import initializer as init_mod
from ..config import resolve_device
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(dtype):
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


# the calling thread's {parameter name: tensor} substitution
# (`block._ParamSubst`), or None
_SUBST = threading.local()


class DeferredInitializationError(Exception):
    """A parameter was read before its shape was known."""


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self.stype = stype
        self.grad_stype = grad_stype
        self._grad_req = grad_req if differentiable else "null"
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._nd = None             # NDArray over the torch.nn.Parameter
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
    def _data(self):
        """The torch.nn.Parameter, or None before materialization."""
        return self._nd._data if self._nd is not None else None

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write, add or null: {req}")
        if req == self._grad_req:
            return
        self._grad_req = req
        if self._nd is not None:
            self._set(self._data.detach())

    def initialize(self, init=None, device=None, default_init=None,
                   force_reinit=False, ctx=None):
        """Initialize with `init`, else the parameter's own `init`, else
        `default_init`, on `device` (`ctx`, a Context, is the reference's
        spelling; neither: the current context, the card unless a `with
        cpu():` scope says otherwise, raising without CUDA). With the
        shape still unknown, the draw waits for the first forward."""
        device = _ctx_device(ctx) if device is None else device
        if device is None:
            device = current_context().torch_device()
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
        data = torch.nn.Parameter(tensor,
                                  requires_grad=self._grad_req != "null")
        if self._nd is None:
            self._nd = NDArray._from_data(data)
        self._nd._data = data
        if self._grad_req != "null":
            autograd.mark_variables([self._nd], [self._empty_grad(tensor)],
                                    self._grad_req)
            self._nd._data = data  # mark_variables detached it
        else:
            self._nd._grad = None

    def _empty_grad(self, tensor):
        """A zero dense buffer, or an empty row_sparse one."""
        if self.grad_stype == "row_sparse":
            from ..ndarray import sparse
            return sparse.zeros("row_sparse", tuple(tensor.shape),
                                ctx=tensor.device, dtype=tensor.dtype)
        return NDArray._from_data(torch.zeros_like(tensor))

    def _check(self):
        if self._nd is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred (shape {self._shape})")
            raise RuntimeError(f"parameter {self.name} not initialized")

    def tensor(self):
        """The parameter's `torch.nn.Parameter`, or its substitute inside
        a `block._ParamSubst` that maps its name."""
        subst = getattr(_SUBST, "map", None)
        if subst is not None and self.name in subst:
            return subst[self.name]
        self._check()
        return self._nd._data

    def data(self, ctx=None):
        """The parameter's NDArray (one per parameter), or an NDArray over
        its substitute inside a `block._ParamSubst`."""
        subst = getattr(_SUBST, "map", None)
        if subst is not None and self.name in subst:
            return NDArray._from_data(subst[self.name])
        self._check()
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient buffer (an NDArray) that `autograd.backward`
        writes by `grad_req`."""
        self._check()
        if self._nd._grad is None:
            raise RuntimeError(f"parameter {self.name} has no gradient "
                               "(grad_req=null?)")
        return self._nd._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self._nd.context] if self._nd is not None else []

    def zero_grad(self):
        """Zero the gradient buffer in place (a row_sparse gradient, or a
        dense one that displaced it, starts again from the empty buffer
        of the parameter's grad_stype)."""
        if self._nd is None or self._nd._grad is None:
            return
        g = self._nd._grad
        if self.grad_stype == "row_sparse" or not isinstance(g, NDArray):
            self._nd._grad = self._empty_grad(self._nd._data)
            return
        with torch.no_grad():
            g._data.zero_()

    def _device(self):
        """The device of the data, or the one `initialize` gave a deferred
        parameter, or None."""
        if self._nd is not None:
            return self._nd._data.device
        if self._deferred_init is not None:
            return self._deferred_init[1]
        return None

    def cast(self, dtype):
        """Hold the data (and create later draws) in `dtype`."""
        self.dtype = dtype
        if self._data is not None:
            self._set(self._data.detach().to(_dtype(dtype)))

    def set_data(self, data):
        """Copy `data` (an NDArray, tensor or array) into the parameter. An
        unmaterialized parameter takes its shape from `data` and lands on
        the device `initialize` gave it (CUDA when it was never
        initialized)."""
        data = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        if self._data is None:
            device = (self._deferred_init[1] if self._deferred_init
                      else current_context().torch_device())
            self._shape = tuple(data.shape)
            self._set(data.to(device=device, dtype=_dtype(self.dtype)).clone())
            self._deferred_init = None
            return
        with torch.no_grad():
            self._data.copy_(data.detach().reshape(self._shape))


def _shape_compatible(old, new):
    if len(old) != len(new):
        return False
    return all(o == n or o in (0, -1) for o, n in zip(old, new))


class Constant(Parameter):
    """A parameter that holds `value` and takes no gradient."""

    def __init__(self, name, value):
        value = np.asarray(value, dtype=np.float32)
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         init=init_mod.Constant(value),
                         differentiable=False)


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

    def get_constant(self, name, value=None):
        """The constant `prefix + name`, created holding `value` if new."""
        name = self._prefix + name
        if name in self._params:
            return self._params[name]
        c = Constant(name, value)
        self._params[name] = c
        return c

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter {k}")
            self._params[k] = v

    def initialize(self, init=None, device=None, force_reinit=False,
                   ctx=None, verbose=False):
        """Initialize every parameter; `ctx` (a Context) is the reference's
        spelling of `device`."""
        device = _ctx_device(ctx) if device is None else device
        for p in self.values():
            p.initialize(init=None, device=device,
                         default_init=init or init_mod.Uniform(0.07),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        pass

    def setattr(self, name, value):
        """Set attribute `name` (grad_req, lr_mult, wd_mult, ...) of every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every materialized parameter by full name (`strip_prefix`
        taken off), in `nd.save`'s container."""
        from ..ndarray import save as nd_save

        arg = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg[name] = p.data()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a `save` file (or the JAX package's), names prefixed with
        `restore_prefix`."""
        from ..context import cpu
        from ..ndarray import load as nd_load

        # staged on the CPU: set_data copies each to its parameter's device
        loaded = nd_load(filename, ctx=cpu())
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise ValueError(f"parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self.keys())
            if extra:
                raise ValueError(f"extra parameters in file: "
                                 f"{sorted(extra)}")


def _ctx_device(ctx):
    """The device of a Context (or of a list of them: the first)."""
    if ctx is None:
        return None
    if isinstance(ctx, (list, tuple)):
        ctx = ctx[0]
    from ..context import to_device
    return to_device(ctx)
