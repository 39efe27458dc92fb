"""Gluon losses (`incubator_mxnet_tpu/gluon/loss.py`): the shared `Loss`
protocol and the softmax cross-entropy ResNet trains with, as
`log_softmax` + `pick`."""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss"]


class Loss(HybridBlock):
    """Shared loss protocol: optional sample_weight scaling, constant
    weight scaling, and the mean over every axis but the batch axis."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _finish(self, F, loss, sample_weight, mean=True):
        if sample_weight is not None:
            loss = loss * sample_weight
        if self._weight is not None and self._weight != 1.0:
            loss = loss * self._weight
        if mean:
            axes = [a for a in range(loss.dim())
                    if a != self._batch_axis % loss.dim()]
            loss = loss.mean(dim=axes) if axes else loss
        return loss

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy over `axis`: sparse integer labels pick their
    log-probability, dense labels contract against the log-probabilities.
    Returns one loss per sample."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else F.log_softmax(pred,
                                                            axis=self._axis)
        if self._sparse_label:
            nll = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            nll = -(logp * label.reshape(logp.shape)).sum(dim=self._axis,
                                                          keepdim=True)
        return self._finish(F, nll, sample_weight)
