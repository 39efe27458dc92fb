"""The fused-epilogue rewrite (`MXTPU_FUSED_EPILOGUE`): BatchNorm -> ReLU
(-> residual add) chains of channels-last nets through one
`kernels.bn_act_epilogue` pass.

The JAX package (`incubator_mxnet_tpu/ops/epilogue.py`) matches the chain
at dispatch time: BatchNorm outputs carry provenance, residual adds pass
it on, and a ReLU whose input carries it re-emits the chain as one Pallas
call; the BN and add already dispatched become dead code that XLA's DCE
deletes. Eager PyTorch has no trace and no DCE, so the same scheme would
compute every BN output twice. The port matches explicitly instead, at
the two call sites the JAX rewrite serves: `nn.HybridSequential` fuses a
`BatchNorm` child followed by an `Activation('relu')` child (the ResNet
stem), and the ResNet residual units call `bn_act(norm, x, residual)` for
their BN -> ReLU pairs and their residual join. What each fused call
computes follows the JAX `_emit`:

- scale = g * rsqrt(var + eps), shift = beta - mean * scale, from the
  BN's own `eps` and `fix_gamma` (g = 1 with `fix_gamma`);
- in training mode (without `use_global_stats`) mean and var are the
  batch's biased moments, differentiable, and the BN's running stats get
  the update its own forward would have made (through
  `ops.nn.write_moving`, so a train step may defer it); otherwise they
  are the running stats;
- only channels-last (axis = last) data of float32 or narrower is
  rewritten; anything else runs unfused. `rewrites_applied` counts the
  fused calls.

With the knob off (the default) `bn_act` runs the unfused BN, add and
ReLU, as the JAX package does.
"""
from __future__ import annotations

import torch

from .. import config
from . import nn as _nn
from .kernels.epilogue import bn_act_epilogue

__all__ = ["enabled", "bn_act", "rewrites_applied"]

# fused calls made, for tests and chip_smoke (reset per check)
rewrites_applied = 0


def enabled():
    return config.get("MXTPU_FUSED_EPILOGUE")


def bn_act(norm, x, residual=None):
    """relu(norm(x) [+ residual]) for a gluon `BatchNorm` block `norm`:
    one fused epilogue when the knob is on and the call is eligible,
    else the unfused ops."""
    if enabled():
        out = _fused(norm, x, residual)
        if out is not None:
            return out
    h = norm(x)
    if residual is not None:
        h = h + residual
    return _nn.activation(h, act_type="relu")


def _fused(norm, x, residual):
    from ..gluon.block import training_mode

    axis = norm._axis % x.dim()
    if axis != x.dim() - 1:
        return None  # the kernel is channels-last only
    if torch.promote_types(x.dtype, torch.float32) != torch.float32:
        return None  # float64 nets keep float64 statistics, unfused
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        return None
    norm._pre_forward(x)
    gamma, beta, running_mean, running_var = (
        p.tensor() for p in (norm.gamma, norm.beta, norm.running_mean,
                           norm.running_var))
    g = gamma if norm._scale else torch.ones_like(gamma)
    if training_mode(norm) and not norm._use_global_stats:
        mean, var = _nn.batch_moments(x, axis)
        new_mean, new_var = _nn.moving_update(running_mean, running_var,
                                              mean, var, norm._momentum)
        _nn.write_moving(running_mean, new_mean)
        _nn.write_moving(running_var, new_var)
    else:
        mean, var = running_mean.float(), running_var.float()
    scale = g.float() * torch.rsqrt(var + norm._epsilon)
    shift = beta.float() - mean * scale
    out = bn_act_epilogue(x, scale, shift, residual)
    global rewrites_applied
    rewrites_applied += 1
    return out
