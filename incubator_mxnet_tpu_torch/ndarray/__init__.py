"""The `F` namespace handed to `HybridBlock.hybrid_forward`: the operators
of `ops/nn.py` under the reference's registry names, on torch tensors.

A namespace only: there is no NDArray class in the port, and no tape
(`torch.autograd` records the ops). `BatchNorm` carries out the
reference's aux-state protocol itself: in training mode it writes the
new moving stats into the moving-mean and moving-variance tensors it was
given, in place, and returns the normalised data alone.
"""
from __future__ import annotations

import torch

from ..ops import nn as _nn

__all__ = ["FullyConnected", "Convolution", "Pooling", "BatchNorm",
           "Activation", "Flatten", "log_softmax", "pick"]

FullyConnected = _nn.fully_connected
Convolution = _nn.convolution
Pooling = _nn.pooling
Activation = _nn.activation
Flatten = _nn.flatten
log_softmax = _nn.log_softmax
pick = _nn.pick


def BatchNorm(data, gamma, beta, moving_mean, moving_var, **attrs):
    """`ops.nn.batch_norm`, with the new moving stats of a training-mode
    call written back into `moving_mean` and `moving_var`."""
    out = _nn.batch_norm(data, gamma, beta, moving_mean, moving_var, **attrs)
    if not attrs.get("_training", False):
        return out
    out, new_mean, new_var = out
    with torch.no_grad():
        moving_mean.copy_(new_mean)
        moving_var.copy_(new_var)
    return out
