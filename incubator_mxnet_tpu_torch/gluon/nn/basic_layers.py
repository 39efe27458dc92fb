"""Gluon basic layers (`incubator_mxnet_tpu/gluon/nn/basic_layers.py`).

`Embedding(sparse_grad=True)` records a row-sparse weight gradient on
the eager tape. `Lambda` / `HybridLambda` given an op name
call the tensor-level `F` function of that name: blocks called with
NDArrays hand their forward the tensors."""
from __future__ import annotations

import functools
import math

import torch

from ... import autograd
from ... import initializer as init_mod
from ...ops import epilogue
from ..block import Block, HybridBlock, _F, _RematUnits, training_mode
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda",
           "ReflectionPad2D"]


class Sequential(Block):
    """Children run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(HybridBlock):
    """Children run in order. With `MXTPU_FUSED_EPILOGUE` on, a
    `BatchNorm` child followed by an `Activation('relu')` child runs as one
    fused epilogue (`ops.epilogue.bn_act`), as the JAX package's dispatch
    time rewrite does for the ResNet stem. Under a train step's remat
    (`block._RematUnits`) each child that is not itself a sequence (and
    each fused pair) runs under its own checkpoint."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        blocks = list(self._modules.values())
        fuse = epilogue.enabled()
        wrap = _RematUnits.current()
        i = 0
        while i < len(blocks):
            if (fuse and isinstance(blocks[i], BatchNorm)
                    and i + 1 < len(blocks)
                    and isinstance(blocks[i + 1], Activation)
                    and blocks[i + 1]._act_type == "relu"):
                fn = functools.partial(epilogue.bn_act, blocks[i])
                i += 2
            else:
                fn = blocks[i]
                i += 1
            x = (fn(x) if wrap is None or isinstance(fn, HybridSequential)
                 else wrap(fn, x))
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """y = x W^T + b (W of shape (units, in_units)), an optional
    activation after."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=init_mod.Zero() if bias_initializer == "zeros"
                    else bias_initializer)
            else:
                self.bias = None

    def _pre_forward(self, x, *args):
        if not self.weight._shape_known():
            in_units = (math.prod(x.shape[1:]) if self._flatten
                        else x.shape[-1])
            self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return f"Dense({self._units})"


class Dropout(HybridBlock):
    """Inverted dropout with rate `rate` (whole slices along `axes`), in
    training mode only."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes,
                             _training=training_mode(self))
        return x


class BatchNorm(HybridBlock):
    """Batch normalization over `axis` (gluon defaults: epsilon 1e-5,
    momentum 0.9, `fix_gamma = not scale`). In training mode it
    normalises with the batch's biased moments and updates its running
    stats in place; in predict mode it normalises with the running
    stats."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=init_mod.One(),
                allow_deferred_init=True,
                grad_req="write" if scale else "null")
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=init_mod.Zero(),
                allow_deferred_init=True,
                grad_req="write" if center else "null")
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,), init=init_mod.Zero(),
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,), init=init_mod.One(),
                allow_deferred_init=True, differentiable=False)

    def _pre_forward(self, x, *args):
        if not self.gamma._shape_known():
            c = x.shape[self._axis]
            for p in (self.gamma, self.beta, self.running_mean,
                      self.running_var):
                p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            _training=training_mode(self))


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)


def _affine(block, name, c, grad):
    init = init_mod.One() if name == "gamma" else init_mod.Zero()
    return block.params.get(name, shape=(c,), init=init,
                            allow_deferred_init=True,
                            grad_req="write" if grad else "null")


class InstanceNorm(HybridBlock):
    """Instance normalization over the spatial dims of NC* data."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = _affine(self, "gamma", in_channels, True)
            self.beta = _affine(self, "beta", in_channels, True)

    def _pre_forward(self, x, *args):
        if not self.gamma._shape_known():
            self.gamma.shape = (x.shape[1],)
            self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class LayerNorm(HybridBlock):
    """Layer normalization over `axis`."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = _affine(self, "gamma", in_channels, True)
            self.beta = _affine(self, "beta", in_channels, True)

    def _pre_forward(self, x, *args):
        if not self.gamma._shape_known():
            c = x.shape[self._axis]
            self.gamma.shape = (c,)
            self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class GroupNorm(HybridBlock):
    """Group normalization over `num_groups` channel groups of NC* data."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._num_groups = int(num_groups)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = _affine(self, "gamma", in_channels, scale)
            self.beta = _affine(self, "beta", in_channels, center)

    def _pre_forward(self, x, *args):
        if not self.gamma._shape_known():
            self.gamma.shape = (x.shape[1],)
            self.beta.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """A (input_dim, output_dim) lookup table for integer indices.

    With `sparse_grad=True` the weight's gradient is row sparse
    (`grad_stype="row_sparse"`): inside `autograd.record()` the lookup
    records only the rows the batch touches (`autograd.sparse_embedding`),
    and the lazy optimizer paths update only those rows. Called with
    tensors (a train step's forward, a CUDA graph capture) the lookup is
    the dense gather, as JAX's jitted path is."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer,
                grad_stype="row_sparse" if sparse_grad else "default")

    def _sparse_tape(self, weight):
        """The eager tape records this lookup row sparse: the weight is
        the parameter's own tensor (no train step's substitute) and no
        CUDA graph is being captured."""
        p = self.weight
        return (p.grad_stype == "row_sparse" and autograd.is_recording()
                and p._nd is not None and weight is p._nd._data
                and not (weight.is_cuda
                         and torch.cuda.is_current_stream_capturing()))

    def hybrid_forward(self, F, x, weight):
        if self._sparse_tape(weight):
            return autograd.sparse_embedding(x, self.weight.data(),
                                             self._input_dim,
                                             self._output_dim)
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Lambda(Block):
    """Wrap a function (or the name of an `F` op) as a block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = (getattr(_F, function) if isinstance(function, str)
                      else function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """Wrap a function `fn(*tensors)` (or the name of an `F` op) as a
    hybrid block; as in the JAX package, the function is not handed
    `F`."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func = None
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "lambda")

    def hybrid_forward(self, F, *args):
        fn = self._func or getattr(F, self._func_name)
        return fn(*args)


class ReflectionPad2D(HybridBlock):
    """Reflection padding on H/W of NCHW input."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if len(padding) != 8:
            raise ValueError(
                "padding must be an int or an 8-tuple (before/after for "
                "each NCHW axis); got %r" % (padding,))
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
