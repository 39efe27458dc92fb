"""Optimizers (`incubator_mxnet_tpu/optimizer.py`): the `Optimizer` base
and `SGD`, with the fused update `GluonTrainStep` applies.

`fused_update` follows the JAX package's `_sgd_fused`: g = rescale_grad
* grad, clipped to +-clip_gradient when set, plus wd * w; with momentum,
mom = momentum * mom - lr * g and w += mom, else w -= lr * g. It updates
the weight and the momentum in place (the JAX step returns new arrays).
Per-parameter multipliers follow the JAX `_mults`: a `param_dict` entry's
`lr_mult` / `wd_mult` (a gluon `Parameter`'s) take priority, else the
`lr_mult` / `wd_mult` dicts, keyed by name.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD"]


class Optimizer:
    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}

    def create_state(self, index, weight):
        return None

    def _mults(self, name, lr):
        """(lr, wd) for the parameter `name`."""
        if name in self.param_dict:
            return (lr * self.param_dict[name].lr_mult,
                    self.wd * self.param_dict[name].wd_mult)
        return (lr * self.lr_mult.get(name, 1.0),
                self.wd * self.wd_mult.get(name, 1.0))

    def fused_update(self, name, weight, grad, state, lr):
        raise NotImplementedError


class SGD(Optimizer):
    """SGD with momentum and weight decay."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight, memory_format=torch.preserve_format)
        return None

    @torch.no_grad()
    def fused_update(self, name, weight, grad, state, lr):
        """One step on `weight` (and its momentum `state`), in place."""
        g = grad * self.rescale_grad
        if self.clip_gradient:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        lr, wd = self._mults(name, lr)
        g = g + wd * weight
        if self.momentum != 0.0 and state is not None:
            state.mul_(self.momentum).sub_(lr * g)
            weight.add_(state)
        else:
            weight.sub_(lr * g)
