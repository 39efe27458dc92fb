"""Gluon losses (`incubator_mxnet_tpu/gluon/loss.py`), table-driven as
there: each elementwise loss is one formula in `_LOSS_TABLE` over the
shared `Loss` protocol (label/pred alignment, sample weighting,
per-sample mean over the non-batch axes); the structured losses are
classes over the same protocol. The formulas run through the
tensor-level `F` namespace.
"""
from __future__ import annotations

import numpy as np

from .block import HybridBlock

__all__ = [
    "Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
    "SigmoidBCELoss",
    "SoftmaxCrossEntropyLoss", "SoftmaxCELoss", "KLDivLoss",
    "HuberLoss", "HingeLoss", "SquaredHingeLoss", "LogisticLoss",
    "TripletLoss", "CosineEmbeddingLoss", "PoissonNLLLoss", "CTCLoss",
]


class Loss(HybridBlock):
    """Shared loss protocol: optional sample_weight scaling, constant
    weight scaling, and mean over all non-batch axes."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _finish(self, F, loss, sample_weight, mean=True):
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        if self._weight is not None and self._weight != 1.0:
            loss = loss * self._weight
        if mean:
            loss = F.mean(loss, axis=self._batch_axis, exclude=True)
        return loss

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _logit_bce(F, z, y):
    """Numerically stable BCE on logits: max(z,0) - z*y + log(1+e^-|z|)."""
    return F.relu(z) - z * y + F.Activation(-F.abs(z), act_type="softrelu")


# name -> (formula(F, pred, aligned_label) -> elementwise loss, extra ctor
# params with defaults, docstring)
_LOSS_TABLE = {
    "L2Loss": (
        lambda F, p, y, s: 0.5 * F.square(y - p),
        {},
        "mean of 0.5 (pred - label)^2",
    ),
    "L1Loss": (
        lambda F, p, y, s: F.abs(y - p),
        {},
        "mean of |pred - label|",
    ),
    "HingeLoss": (
        lambda F, p, y, s: F.relu(s["margin"] - p * y),
        {"margin": 1},
        "mean of max(0, margin - pred*label), labels in {-1, +1}",
    ),
    "SquaredHingeLoss": (
        lambda F, p, y, s: F.square(F.relu(s["margin"] - p * y)),
        {"margin": 1},
        "mean of max(0, margin - pred*label)^2, labels in {-1, +1}",
    ),
    "HuberLoss": (
        lambda F, p, y, s: F.where(
            F.abs(y - p) > s["rho"],
            F.abs(y - p) - 0.5 * s["rho"],
            (0.5 / s["rho"]) * F.square(y - p)),
        {"rho": 1},
        "smoothed L1: quadratic inside rho, linear outside",
    ),
    "LogisticLoss": (
        lambda F, p, y, s: _logit_bce(
            F, p, (y + 1.0) / 2.0 if s["label_format"] == "signed" else y),
        {"label_format": "signed"},
        "binary logistic loss on logits; labels signed {-1,1} or binary {0,1}",
    ),
}


def _make_elementwise_loss(name, formula, params, doc):
    # positional order matches the reference signatures: the loss's own
    # params first (e.g. HuberLoss(rho, ...)), then weight, batch_axis
    arg_names = list(params) + ["weight", "batch_axis"]
    defaults = {**params, "weight": 1.0, "batch_axis": 0}

    def __init__(self, *args, **kwargs):
        if len(args) > len(arg_names):
            raise TypeError(f"{name} takes at most {len(arg_names)} "
                            f"positional arguments")
        for n, v in zip(arg_names, args):
            if n in kwargs:
                raise TypeError(f"{name} got multiple values for {n!r}")
            kwargs[n] = v
        own = {k: kwargs.pop(k, defaults[k]) for k in params}
        Loss.__init__(self, kwargs.pop("weight", 1.0),
                      kwargs.pop("batch_axis", 0), **kwargs)
        self._p = own

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        return self._finish(F, formula(F, pred, label, self._p), sample_weight)

    cls = type(name, (Loss,), {
        "__init__": __init__,
        "hybrid_forward": hybrid_forward,
        "__doc__": doc,
    })
    return cls


for _name, (_formula, _params, _doc) in _LOSS_TABLE.items():
    globals()[_name] = _make_elementwise_loss(_name, _formula, _params, _doc)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE over sigmoid outputs or (default) raw logits via the stable
    log-sum-exp form."""

    def __init__(self, from_sigmoid=False, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = F.reshape_like(label, pred)
        if self._from_sigmoid:
            eps = 1e-12
            pos = F.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + F.log(1.0 - pred + eps) * (1.0 - label))
        elif pos_weight is None:
            loss = _logit_bce(F, pred, label)
        else:
            # weighted stable form: (1-y)z + (1+(pw-1)y) * log(1+e^-z),
            # with log(1+e^-z) written as softrelu(-|z|) + relu(-z)
            log_weight = 1.0 + (pos_weight - 1.0) * label
            loss = (pred - pred * label
                    + log_weight * (F.Activation(-F.abs(pred),
                                                 act_type="softrelu")
                                    + F.relu(-pred)))
        return self._finish(F, loss, sample_weight)


class SoftmaxCrossEntropyLoss(Loss):
    """CE over an axis: sparse integer labels gather their log-prob; dense
    labels contract against log-probs; one loss per sample."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = (pred if self._from_logits
                else F.log_softmax(pred, axis=self._axis))
        if self._sparse_label:
            nll = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            nll = -F.sum(logp * F.reshape_like(label, logp),
                         axis=self._axis, keepdims=True)
        return self._finish(F, nll, sample_weight)


class KLDivLoss(Loss):
    """KL(label || softmax(pred)); pred is log-probability when from_logits."""

    def __init__(self, from_logits=True, axis=-1, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = (pred if self._from_logits
                else F.log_softmax(pred, axis=self._axis))
        return self._finish(F, label * (F.log(label + 1e-12) - logp),
                            sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification over the `CTCLoss` op, per
    sample: `layout` "NTC" or "TNC" for the predictions, `label_layout`
    "NT" or "TN"; optional `pred_lengths` / `label_lengths`."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None)
        return self._finish(F, loss, sample_weight, mean=False)


class TripletLoss(Loss):
    """max(0, margin + d(pred, pos) - d(pred, neg)) with squared-L2
    distances summed per sample."""

    def __init__(self, margin=1, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        d_pos = F.square(F.reshape_like(positive, pred) - pred)
        d_neg = F.square(F.reshape_like(negative, pred) - pred)
        gap = F.sum(d_pos - d_neg, axis=self._batch_axis, exclude=True)
        return self._finish(F, F.relu(gap + self._margin), sample_weight,
                            mean=False)


class CosineEmbeddingLoss(Loss):
    """1 - cos(a, b) for matching pairs, max(0, cos - margin) for
    non-matching."""

    def __init__(self, weight=1.0, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        a = input1.reshape((input1.shape[0], -1))
        b = input2.reshape((input2.shape[0], -1))
        cos = F.sum(a * b, axis=1) / F.sqrt(
            F.sum(F.square(a), axis=1) * F.sum(F.square(b), axis=1) + 1e-12)
        loss = F.where(label.reshape((-1,)) == 1,
                       1.0 - cos, F.relu(cos - self._margin))
        return self._finish(F, loss, sample_weight, mean=False)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss
SoftmaxCELoss = SoftmaxCrossEntropyLoss


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood:
    exp(pred) - label*pred on logits, or pred - label*log(pred+eps) on
    rates; compute_full adds the Stirling approximation of log(label!).
    Reduces to the SCALAR mean over all axes, matching the reference's
    unique reduction for this loss."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       epsilon=1e-08):
        label = F.reshape_like(label, pred)
        if self._from_logits:
            loss = F.exp(pred) - label * pred
        else:
            loss = pred - label * F.log(pred + epsilon)
        if self._compute_full:
            # Stirling term for label > 1: y log y - y + 0.5 log(2 pi y)
            stirling = (label * F.log(label + epsilon) - label
                        + 0.5 * F.log(2.0 * np.pi * (label + epsilon)))
            loss = loss + F.where(label > 1.0, stirling,
                                  F.zeros_like(stirling))
        loss = self._finish(F, loss, sample_weight, mean=False)
        return F.mean(loss)
