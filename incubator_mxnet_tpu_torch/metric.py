"""Evaluation metrics (`incubator_mxnet_tpu/metric.py`, the port's own
copy): the 18 metric classes, `np` and `create`. Each metric reads its
labels and predictions on the host as numpy arrays: port NDArrays, torch
tensors (on any device; bfloat16 as float32) and array-likes. Reading a
device value waits for it, as the reference's metrics do.
"""
from __future__ import annotations

import math

import numpy as _numpy
import torch

from .ndarray.ndarray import NDArray

__all__ = [
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC",
    "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
    "PearsonCorrelation", "Loss", "Torch", "Caffe", "CustomMetric", "np", "create",
]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    # names compare without "-" and "_", so JAX's aliases with either
    # ("top_k_accuracy", "cross-entropy", ...) and the class names all
    # reach their metric
    aliases = {"acc": "accuracy", "ce": "crossentropy",
               "nllloss": "negativeloglikelihood", "topkacc": "topkaccuracy",
               "composite": "compositeevalmetric", "custom": "custommetric"}
    key = metric.lower().replace("-", "").replace("_", "")
    key = aliases.get(key, key)
    return _REGISTRY[key](*args, **kwargs)


def _asnp(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return _numpy.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    @staticmethod
    def _select(mapping, names):
        """Ordered values, filtered to `names` when given."""
        if names is None:
            return list(mapping.values())
        return [mapping[n] for n in names]

    def update_dict(self, label, pred):
        self.update(self._select(label, self.label_names),
                    self._select(pred, self.output_names))

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        mean = (self.sum_metric / self.num_inst if self.num_inst
                else float("nan"))
        return (self.name, mean)

    def get_name_value(self):
        name, value = self.get()
        as_list = lambda v: v if isinstance(v, list) else [v]  # noqa: E731
        return list(zip(as_list(name), as_list(value)))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def _check_same_len(labels, preds):
    if len(labels) != len(preds):
        raise ValueError(f"labels/preds count mismatch: {len(labels)} vs {len(preds)}")


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        _check_same_len(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label), _asnp(pred)
            if pred.ndim > label.ndim:
                pred = _numpy.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").flatten()
            label = label.astype("int32").flatten()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None, label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds):
        _check_same_len(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label).astype("int32"), _asnp(pred)
            topk = _numpy.argsort(pred, axis=-1)[:, -self.top_k:]
            self.sum_metric += float((topk == label.reshape(-1, 1)).any(axis=1).sum())
            self.num_inst += len(label)


class _ConfusionMetric(EvalMetric):
    """Shared streaming 2x2 confusion table for the binary metrics: one
    vectorized count per batch (predicted class x true class), from which
    F1 and MCC derive their closed forms."""

    def reset(self):
        self.counts = _numpy.zeros((2, 2))  # [pred][true]
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            y = _asnp(label).flatten()
            p = _asnp(pred)
            if p.ndim > 1:
                p = _numpy.argmax(p, axis=-1)
            p = p.flatten()
            # membership test on the RAW values (0.7 is neither class, not
            # class 0), then bincount the joint index 2*pred + true to fill
            # all four cells in one pass
            ok = ((y == 0) | (y == 1)) & ((p == 0) | (p == 1))
            joint = _numpy.bincount(
                2 * p[ok].astype(int) + y[ok].astype(int), minlength=4)
            self.counts += joint.reshape(2, 2)
            self.num_inst += 1

    @property
    def _cells(self):
        """(tp, fp, fn, tn) from the table."""
        return (self.counts[1, 1], self.counts[1, 0],
                self.counts[0, 1], self.counts[0, 0])


@register
class F1(_ConfusionMetric):
    def __init__(self, name="f1", output_names=None, label_names=None, average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average

    def get(self):
        tp, fp, fn, _ = self._cells
        # harmonic mean of precision and recall == 2tp / (2tp + fp + fn)
        f1 = 2 * tp / max(2 * tp + fp + fn, 1e-12)
        return (self.name, f1 if self.num_inst else float("nan"))


@register
class MCC(_ConfusionMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None, average="macro"):
        super().__init__(name, output_names, label_names)

    def get(self):
        tp, fp, fn, tn = self._cells
        # correlation of the 2x2 table: cov / sqrt(prod of marginals)
        marginals = [tp + fp, tp + fn, tn + fp, tn + fn]
        denom = math.sqrt(math.prod(marginals))
        mcc = (tp * tn - fp * fn) / denom if denom else 0.0
        return (self.name, mcc if self.num_inst else float("nan"))


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label), _asnp(pred)
            label = label.astype("int32").flatten()
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_numpy.arange(len(label)), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(_numpy.sum(_numpy.log(_numpy.maximum(1e-10, probs))))
            num += len(label)
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label), _asnp(pred)
            self.sum_metric += float(_numpy.abs(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label), _asnp(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label).astype("int32").flatten(), _asnp(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            prob = pred[_numpy.arange(len(label)), label]
            self.sum_metric += float((-_numpy.log(prob + self.eps)).sum())
            self.num_inst += len(label)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None, label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names, label_names=label_names)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _asnp(label).flatten(), _asnp(pred).flatten()
            cc = _numpy.corrcoef(pred, label)[0, 1]
            self.sum_metric += float(cc)
            self.num_inst += 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            loss = float(_asnp(pred).sum())
            self.sum_metric += loss
            self.num_inst += _asnp(pred).size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name if name is not None else getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            _check_same_len(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_asnp(label), _asnp(pred))
            if isinstance(reval, tuple):
                num_inst, sum_metric = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (ref: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "feval")
    return CustomMetric(feval, name, allow_extra_outputs)
