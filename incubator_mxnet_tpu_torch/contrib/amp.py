"""Automatic mixed precision (`incubator_mxnet_tpu/contrib/amp.py`; ref:
python/mxnet/contrib/amp/amp.py - init:87, init_trainer:338,
scale_loss:311, loss_scaler.py DynamicLossScaler).

`convert_block` casts a gluon block to a reduced-precision dtype and
keeps the BatchNorm parameters and statistics in float32. bfloat16 (the
default target) shares float32's exponent range and trains without loss
scaling; float16 does not, and the dynamic loss scaler is for it: the
scale grows 2x every `scale_window` clean steps and halves on any
non-finite gradient, with the overflowed step skipped (the reference's
policy). `init_trainer` attaches a scaler to a gluon `Trainer`, whose
step unscales by the scale `scale_loss` applied and skips a step whose
gradients overflowed.
"""
from __future__ import annotations

import torch

from .. import autograd as _ag
from .. import telemetry as _telemetry
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["init", "init_trainer", "convert_block", "convert_model",
           "scale_loss", "DynamicLossScaler"]

_F32_KEEP_SUFFIXES = ("gamma", "beta", "running_mean", "running_var",
                      "moving_mean", "moving_var")


def init(target_dtype="bfloat16"):
    """Enable AMP defaults (kept for the API; casting is explicit)."""
    return target_dtype


def convert_block(block, target_dtype="bfloat16"):
    """Cast a gluon block to reduced-precision compute, float32 norm
    parameters and statistics."""
    for name, p in block.collect_params().items():
        if name.endswith(_F32_KEEP_SUFFIXES):
            continue
        p.cast(target_dtype)
    return block


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16"):
    """Cast a symbolic checkpoint's arguments (ref: amp convert_model)."""
    new_args = {}
    for k, v in arg_params.items():
        if k.endswith(_F32_KEEP_SUFFIXES):
            new_args[k] = v
        else:
            new_args[k] = v.astype(target_dtype)
    return sym, new_args, dict(aux_params)


def _grad_data(g):
    """The tensor of a gradient: a dense NDArray's, a row-sparse one's
    rows, or an array-like's (on the default context's device)."""
    from ..ndarray.sparse import BaseSparseNDArray

    if isinstance(g, torch.Tensor):
        return g
    if isinstance(g, BaseSparseNDArray):
        return g.data._data
    if isinstance(g, NDArray):
        return g._data
    return torch.as_tensor(g, device=current_context().torch_device())


class DynamicLossScaler:
    """Grow-on-success / halve-on-overflow loss scale (ref:
    contrib/amp/loss_scaler.py - init_scale 2**16, scale_factor 2,
    scale_window 2000)."""

    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, min_scale=1.0):
        self.loss_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self._unskipped = 0

    def has_overflow(self, grads):
        """True if any gradient holds a non-finite value. The per-gradient
        flags are OR-ed on the device and read once (the reference's
        multi_all_finite plays the same role)."""
        flags = [~torch.isfinite(_grad_data(g)).all() for g in grads]
        return bool(torch.stack(flags).any()) if flags else False

    def update_scale(self, overflow):
        prev = self.loss_scale
        if overflow:
            self.loss_scale = max(self.min_scale,
                                  self.loss_scale / self.scale_factor)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self.scale_window:
                self.loss_scale *= self.scale_factor
                self._unskipped = 0
        _telemetry.set_gauge(
            "mxtpu_loss_scale", self.loss_scale,
            help="Current dynamic loss scale of the AMP scaler (moves on "
                 "overflow backoff and growth-window promotion).")
        if self.loss_scale != prev:
            # a shrinking scale trail in a post-mortem dump flags
            # numeric instability
            _telemetry.log_event(
                "loss_scale_change", scale=self.loss_scale, prev=prev,
                cause="overflow" if overflow else "growth")


def init_trainer(trainer, scaler=None):
    """Attach dynamic loss scaling to a gluon Trainer (ref:
    amp.init_trainer:338): `scale_loss` multiplies the loss by the live
    scale; the trainer unscales through rescale_grad and skips any step
    whose gradients overflowed, halving the scale."""
    trainer._amp_scaler = scaler or DynamicLossScaler()
    return trainer._amp_scaler


class scale_loss:
    """Context manager yielding the scaled loss (ref: amp.scale_loss:311).

    with amp.scale_loss(loss, trainer) as scaled:
        scaled.backward()
    trainer.step(batch)   # unscales via rescale_grad; skips on overflow
    """

    def __init__(self, loss, optimizer_or_trainer, scale=None):
        self._trainer = optimizer_or_trainer
        scaler = getattr(optimizer_or_trainer, "_amp_scaler", None)
        self._scale = (scale if scale is not None
                       else (scaler.loss_scale if scaler else 1.0))
        self._loss = loss

    def __enter__(self):
        # the trainer unscales by the scale applied here, also when the
        # caller overrode it
        if hasattr(self._trainer, "_amp_scaler"):
            self._trainer._amp_applied_scale = self._scale
        if self._scale == 1.0:
            return self._loss
        # the multiply lands on the tape also when the caller scales
        # outside record() (the reference permits both placements)
        with _ag._AutogradScope(recording=True):
            if isinstance(self._loss, (list, tuple)):
                return type(self._loss)(l * self._scale for l in self._loss)
            return self._loss * self._scale

    def __exit__(self, *exc):
        return False
