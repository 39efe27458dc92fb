"""Gluon basic layers (`incubator_mxnet_tpu/gluon/nn/basic_layers.py`):
the ones ResNet needs."""
from __future__ import annotations

import math

from ... import initializer as init_mod
from ...ops import epilogue
from ..block import HybridBlock
from .activations import Activation

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Flatten"]


class HybridSequential(HybridBlock):
    """Children run in order. With `MXTPU_FUSED_EPILOGUE` on, a
    `BatchNorm` child followed by an `Activation('relu')` child runs as one
    fused epilogue (`ops.epilogue.bn_act`), as the JAX package's dispatch
    time rewrite does for the ResNet stem."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        blocks = list(self._modules.values())
        fuse = epilogue.enabled()
        i = 0
        while i < len(blocks):
            if (fuse and isinstance(blocks[i], BatchNorm)
                    and i + 1 < len(blocks)
                    and isinstance(blocks[i + 1], Activation)
                    and blocks[i + 1]._act_type == "relu"):
                x = epilogue.bn_act(blocks[i], x)
                i += 2
                continue
            x = blocks[i](x)
            i += 1
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
            _training=self.training)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)
