"""Gluon blocks as `torch.nn.Module`s (`incubator_mxnet_tpu/gluon/block.py`).

Carried over: the prefix and name-scope naming, so that every parameter
gets the JAX package's name (a top-level block takes `<alias><n>_` from a
per-process counter; children created inside `name_scope()` take
`<alias><k>_` from their parent's counter); `collect_params`;
`initialize(init, device=None)`; deferred shapes resolved by each layer's
`_pre_forward` from its first input; and `hybrid_forward(F, x, **params)`
with `F` the port's operator namespace (`incubator_mxnet_tpu_torch.ndarray`)
and the block's parameters passed by attribute name.

PyTorch idiom in place of the JAX package's machinery: children are
submodules, parameters' data are `torch.nn.Parameter`s, `torch.autograd`
records the ops, and the training flag is `nn.Module.training`. A block
starts in predict mode (`training` False), as a gluon block outside
`autograd.record(train_mode=True)` does; `train()` turns training mode on
for the block and its children. `hybridize()` is a no-op: PyTorch runs
eagerly and there is no cached graph to build. Not ported: `SymbolBlock`,
`export` and parameter files.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import ndarray as _F
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


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

    def initialize(self, init=None, device=None, force_reinit=False):
        """Initialize every parameter (see `Parameter.initialize`);
        `device` None means CUDA and raises without it."""
        self.collect_params().initialize(init, device, force_reinit)

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
        return {name: p.data() for name, p in self._reg_params.items()}

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
