"""Gluon blocks as `torch.nn.Module`s (`incubator_mxnet_tpu/gluon/block.py`).

Carried over: the prefix and name-scope naming, so that every parameter
gets the JAX package's name (a top-level block takes `<alias><n>_` from a
per-process counter; children created inside `name_scope()` take
`<alias><k>_` from their parent's counter); `collect_params`;
`initialize(init, device=None)`; deferred shapes resolved by each layer's
`_pre_forward` from its first input; `hybrid_forward(F, x, **params)`
with `F` the registry's tensor-level namespace (`ndarray.register.F`)
and the block's parameters passed by attribute name, as tensors; and
`save_parameters` / `load_parameters` in `nd.save`'s container.

Called with NDArrays, as in the JAX package (`net(x)` inside
`autograd.record()`), a block returns NDArrays. A `HybridBlock` hands
its `hybrid_forward` the arrays' tensors, moving a CPU array (a
`DataLoader` batch) to the parameters' device, or, for a block without
parameters (a loss), to the card another input is on (`input_copies`
counts those copies); a plain `Block` hands its `forward` the
NDArrays. For the
call the block and its children take their mode from
`autograd.is_training()`, and the ops run under `torch.no_grad()`
unless `autograd.is_recording()`, so nothing outside `record()` builds
a graph. Called with tensors (`fused.GluonTrainStep`, the model zoo's
train steps) a block behaves as a `torch.nn.Module`: its mode is
`nn.Module.training` (a block starts in predict mode; `train()` turns
training mode on for the block and its children) and torch's grad mode
is the caller's.

PyTorch idiom in place of the JAX package's machinery: children are
submodules, parameters' data are `torch.nn.Parameter`s, `torch.autograd`
records the ops, and forward hooks are torch's. `hybridize()` is a
no-op: PyTorch runs eagerly and there is no cached graph to build. Not
ported: `SymbolBlock` and `export` (the symbolic slice).
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from ..ndarray.ndarray import NDArray
from ..ndarray.register import F as _F
from . import parameter as _parameter
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "training_mode", "imperative_call"]

# CPU arrays moved to the parameters' device by an imperative call
input_copies = 0

# the calling thread's mode for an imperative (NDArray) call, or None
_MODE = threading.local()


def training_mode(block):
    """The mode `block` runs in: `autograd.is_training()` inside an
    imperative call, else the block's own `training` flag."""
    mode = getattr(_MODE, "training", None)
    return block.training if mode is None else mode


def _wrap(out):
    if torch.is_tensor(out):
        return NDArray._from_data(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    return out


def _arrays(tree):
    for a in tree:
        if isinstance(a, NDArray):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _arrays(a)


def _unwrap_array(a, device):
    global input_copies
    if isinstance(a, (list, tuple)):
        return type(a)(_unwrap_array(x, device) for x in a)
    if not isinstance(a, NDArray):
        return a
    a = a._data
    if device is not None and a.device != device:
        a = a.to(device, non_blocking=True)
        input_copies += 1
    return a


def imperative_call(block, fn, *args, **kwargs):
    """`fn(*args, **kwargs)` as an imperative call of `block`: a
    `HybridBlock` gets the NDArrays' tensors (`Block._unwrap`), the block
    and its children take their mode from `autograd.is_training()`, the
    ops record only inside `autograd.record()`, and the result comes back
    as NDArrays."""
    if isinstance(block, HybridBlock):
        args = block._unwrap(args)
    prev = getattr(_MODE, "training", None)
    _MODE.training = autograd.is_training()
    try:
        with torch.set_grad_enabled(autograd.is_recording()):
            out = fn(*args, **kwargs)
    finally:
        _MODE.training = prev
    return _wrap(out)


class _ParamSubst:
    """Within the context, `Parameter.tensor()` of every name in `mapping`
    ({full name: tensor}) returns the mapped tensor, on the calling
    thread: the train step's forward sees its compute-dtype copies (and
    a recomputed forward, entering the context again, the same ones)."""

    def __init__(self, mapping):
        self.mapping = mapping

    def __enter__(self):
        self._prev = getattr(_parameter._SUBST, "map", None)
        _parameter._SUBST.map = self.mapping
        return self

    def __exit__(self, *exc):
        _parameter._SUBST.map = self._prev

    @staticmethod
    def current():
        """The calling thread's mapping, or None."""
        return getattr(_parameter._SUBST, "map", None)


_UNITS = threading.local()


class _RematUnits:
    """Within the context, a `HybridSequential` on the calling thread runs
    each child that is not itself a `HybridSequential` (a residual unit,
    a layer) as `wrap(fn, x)` instead of `fn(x)`: the train step's remat
    checkpoints each unit on its own. `wrap` None turns it off (inside a
    unit, so that units do not nest)."""

    def __init__(self, wrap):
        self.wrap = wrap

    def __enter__(self):
        self._prev = getattr(_UNITS, "wrap", None)
        _UNITS.wrap = self.wrap
        return self

    def __exit__(self, *exc):
        _UNITS.wrap = self._prev

    @staticmethod
    def current():
        """The calling thread's `wrap`, or None."""
        return getattr(_UNITS, "wrap", None)


class _BlockScope:
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = hint + str(_NameManager.next(hint)) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f"{hint}{count}_"
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        _BlockScope._current.value = self._old_scope


class _NameManager:
    _counters = {}

    @classmethod
    def next(cls, hint):
        c = cls._counters.get(hint, 0)
        cls._counters[hint] = c + 1
        return c


class Block(torch.nn.Module):
    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = (self._prefix[:-1] if self._prefix.endswith("_")
                      else self._prefix)
        self._scope = _BlockScope(self)
        self._reg_params = {}
        self.training = False

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__.setdefault("_reg_params", {})[name] = value
            self._params._params[value.name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select=None):
        """This block's and its children's parameters by full name, in
        registration order; `select` a regex the names must match."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({n: p for n, p in self.params.items()
                        if pattern.match(n)})
        for child in self._modules.values():
            if isinstance(child, Block):
                ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structure-relative name ('features.0.weight')."""
        if prefix:
            prefix += "."
        ret = {prefix + name: p for name, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        """PyTorch's view of the materialized gluon parameters, by
        structure-relative name."""
        for name, p in self._collect_params_with_prefix(prefix).items():
            if p._data is not None:
                yield name, p._data

    def initialize(self, init=None, device=None, force_reinit=False,
                   ctx=None, verbose=False):
        """Initialize every parameter (see `Parameter.initialize`);
        `device` None means CUDA and raises without it (`ctx`, a Context,
        is the reference's spelling)."""
        self.collect_params().initialize(init, device, force_reinit,
                                         ctx=ctx)

    def _param_device(self):
        """The device of the first parameter that has one, or None."""
        for p in self._params.values():
            dev = p._device()
            if dev is not None:
                return dev
        for child in self._modules.values():
            if isinstance(child, Block):
                dev = child._param_device()
                if dev is not None:
                    return dev
        return None

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, NDArray) for a in args):
            return super().__call__(*args, **kwargs)
        return imperative_call(self, super().__call__, *args, **kwargs)

    def _unwrap(self, args):
        """The arrays' tensors (in lists too: a cell's states), a CPU one
        moved to the parameters' device (for a block without parameters,
        a loss: to another input's card)."""
        device = self._param_device()
        if device is None:
            device = next((a._data.device for a in _arrays(args)
                           if a._data.is_cuda), None)
        return [_unwrap_array(a, device) for a in args]

    def summary(self, *inputs):
        """Run the block once on `inputs` (the JAX package prints nothing
        more either) and return the output."""
        return self(*inputs)

    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters by structure-relative name ('0.weight'), in
        `nd.save`'s container."""
        from ..ndarray import save as nd_save

        params = self._collect_params_with_prefix()
        nd_save(filename, {n: p.data() for n, p in params.items()
                           if p._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a `save_parameters` file (or a `ParameterDict.save` one, by
        full names), the port's or the JAX package's."""
        from ..context import cpu
        from ..ndarray import load as nd_load

        # staged on the CPU: set_data copies each to its parameter's device
        loaded = nd_load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if loaded and params and not any(k in params for k in loaded):
            params = dict(self.collect_params().items())
        for name, p in params.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise ValueError(f"parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params.keys())
            if extra:
                raise ValueError(f"extra parameters: {sorted(extra)}")

    save_params = save_parameters
    load_params = load_parameters

    def cast(self, dtype):
        """Cast every parameter of the block and its children to
        `dtype`."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self.params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """A no-op kept for the reference's API: PyTorch runs eagerly, and
        there is no cached graph to build."""

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    def forward(self, x, *args):
        self._pre_forward(x, *args)
        return self.hybrid_forward(_F, x, *args, **self._param_kwargs())

    def _pre_forward(self, *args):
        """Hook: layers resolve deferred parameter shapes from the first
        input."""

    def _param_kwargs(self):
        return {name: p.tensor() for name, p in self._reg_params.items()}

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
