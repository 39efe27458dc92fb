"""The generated op functions (`incubator_mxnet_tpu/ndarray/register.py`):
one `nd.<name>` per registry entry over NDArrays (`install_ops`), and
`F`, the tensor-level namespace `HybridBlock.hybrid_forward` receives.

`invoke` keeps the JAX package's rules: positional arguments past the
op's tensor inputs fill its attributes in signature order; `out=`
receives a single-output result. Ops without NDArray inputs make their
result on `ctx` (None: the current context). `nd.<name>` takes NDArrays
and array-likes, never torch tensors: those go through `F.<name>`.
JAX's eager jit cache (`MXTPU_EAGER_JIT`) has no counterpart: eager
PyTorch has nothing to compile.

Inside a running profiler window (`profiler.set_state("run")`) both
dispatch through `profiler.profiled_call`: the op is a named range on
the trace and, with `aggregate_stats`, a timed row of the aggregate
table (JAX's hook in `ndarray/register.invoke`; the port's blocks call
`F`, whose functions the profiler swaps for profiled ones while a window
runs, `profile_F`).

Both call the op through `_call`, which holds the rules for the hidden
arguments: an op that draws gets `_rng` (a generator from the global
random state, on the inputs' device), an op that needs the mode gets
`_training` (`autograd.is_training()`), each unless the caller passes
it; in training mode an op with aux inputs (BatchNorm's moving stats)
has its new aux values written into those inputs through
`ops.nn.write_moving` (in place, or into a train step's deferral sink)
and returns its primary outputs alone.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from .. import autograd
from .. import profiler as _profiler
from .. import random as _random
from ..context import to_device
from ..ops import nn as _nn
from ..ops.registry import OP_REGISTRY, OpDef
from .ndarray import NDArray

__all__ = ["invoke", "invoke_by_name", "install_ops", "F"]


def _tensor(x, device):
    if x is None:
        return x
    if isinstance(x, NDArray):
        return x._data
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def _parse(opdef, args, kwargs):
    """(slots, attrs) by the JAX package's rules."""
    if opdef.variadic:
        return list(args), {k: v for k, v in kwargs.items()
                            if v is not None or k in opdef.attrs}
    slots = [None] * len(opdef.inputs)
    attrs, positional = {}, set()
    attr_names = list(opdef.attrs)
    for i, a in enumerate(args):
        if i < len(slots):
            slots[i] = a
        else:
            j = i - len(slots)
            if j >= len(attr_names):
                raise TypeError(
                    f"op {opdef.name}: too many positional arguments")
            attrs[attr_names[j]] = a
            positional.add(attr_names[j])
    for k, v in kwargs.items():
        if k in opdef.inputs:
            slots[opdef.inputs.index(k)] = v
        else:
            if k in positional:
                raise TypeError(f"op {opdef.name}: got multiple values for "
                                f"argument {k!r}")
            attrs[k] = v
    return slots, attrs


def invoke(opdef: OpDef, args, kwargs):
    """Eager invocation of a registered op over NDArrays."""
    kwargs = dict(kwargs)
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    ctx = kwargs.pop("ctx", None) if "ctx" not in opdef.attrs else None
    slots, attrs = _parse(opdef, args, kwargs)
    unknown = {k for k in attrs if k not in opdef.attrs}
    if unknown:
        raise TypeError(f"op {opdef.name}: unknown arguments "
                        f"{sorted(unknown)}")
    call_attrs = dict(opdef.attrs)
    call_attrs.update(attrs)

    if any(torch.is_tensor(s) for s in slots):
        raise TypeError(f"nd.{opdef.name} takes NDArrays, not torch tensors: "
                        f"call ndarray.register.F.{opdef.name} on tensors")
    arrays = [s for s in slots if isinstance(s, NDArray)]
    device = arrays[0]._data.device if arrays else to_device(ctx)
    tensors = [_tensor(s, device) for s in slots]
    for a in (opdef.aux if not opdef.variadic else ()):
        ap = opdef.inputs.index(a)
        if tensors[ap] is not None:
            tensors[ap] = tensors[ap].detach()

    def fn(*ts):
        return _call(opdef, ts, dict(call_attrs), device)

    if _profiler._STATE["running"]:
        results = _profiler.profiled_call(
            opdef.name, autograd.invoke_recorded, fn, tensors,
            name=opdef.name)
    else:
        results = autograd.invoke_recorded(fn, tensors, name=opdef.name)
    if not arrays:
        for r in results:
            if r._data.device != device:
                r._data = r._data.to(device)
    if out is not None:
        if len(results) != 1:
            raise ValueError("out= supported only for single-output ops")
        r = results[0]._data
        if (not autograd.is_recording() and out._data.shape == r.shape
                and out._data.dtype == r.dtype):
            with torch.no_grad():
                out._data.copy_(r)
        else:
            out._data = r
        return out
    return results if len(results) > 1 else results[0]


def invoke_by_name(name, args, kwargs):
    return invoke(OP_REGISTRY[name], args, kwargs)


def _make_fn(opdef: OpDef, public_name: str):
    def generated(*args, **kwargs):
        return invoke(opdef, args, kwargs)

    generated.__name__ = public_name
    generated.__qualname__ = public_name
    generated.__doc__ = opdef.fn.__doc__ or f"Eager op `{opdef.name}`."
    return generated


def install_ops(module_dict):
    """Install one function per registry entry into a module namespace."""
    for name, opdef in OP_REGISTRY.items():
        if name not in module_dict:
            module_dict[name] = _make_fn(opdef, name)


def _device_of(args, kwargs):
    """The device of the first tensor among the arguments, positional or
    keyword (the CPU when there is none)."""
    for a in (*args, *kwargs.values()):
        if torch.is_tensor(a):
            return a.device
    return torch.device("cpu")


def _call(opdef: OpDef, args, kwargs, device):
    """`opdef.fn(*args, **kwargs)` under the rules for `_rng`, `_training`
    and aux write-back (module docstring); `kwargs` is the caller's own
    dict, which this fills in."""
    if opdef.needs_training and "_training" not in kwargs:
        kwargs["_training"] = autograd.is_training()
    if opdef.needs_rng and "_rng" not in kwargs:
        kwargs["_rng"] = _random.next_generator(device)
    res = opdef.fn(*args, **kwargs)
    if not (opdef.aux and kwargs.get("_training")):
        return res
    n = len(res) - len(opdef.aux)
    for name, new in zip(opdef.aux, res[n:]):
        ap = opdef.inputs.index(name)
        target = args[ap] if ap < len(args) else kwargs.get(name)
        if target is not None:
            _nn.write_moving(target, new)
    return res[0] if n == 1 else tuple(res[:n])


def _tensor_fn(opdef: OpDef):
    """The op's function over tensors, as F hands it out."""
    if not (opdef.needs_rng or opdef.needs_training or opdef.aux):
        return opdef.fn

    def call(*args, **kwargs):
        return _call(opdef, args, kwargs, _device_of(args, kwargs))

    call.__name__ = opdef.name
    call.__doc__ = opdef.fn.__doc__
    return call


F = types.SimpleNamespace(**{name: _tensor_fn(opdef)
                             for name, opdef in OP_REGISTRY.items()})
_PLAIN_F = dict(vars(F))


def _profiled(op_name, fn):
    def call(*args, **kwargs):
        return _profiler.profiled_call(op_name, fn, *args, **kwargs)

    call.__name__ = fn.__name__
    call.__doc__ = fn.__doc__
    return call


def profile_F(on):
    """Route every `F.<name>` through `profiler.profiled_call` (on), or
    back to the plain functions (off): the profiler turns it on for a
    running window, so outside one `F` costs nothing."""
    for name, fn in _PLAIN_F.items():
        setattr(F, name, _profiled(OP_REGISTRY[name].name, fn) if on
                else fn)
