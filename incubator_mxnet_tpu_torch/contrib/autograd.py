"""The legacy experimental autograd API (`incubator_mxnet_tpu/contrib/
autograd.py`): `train_section` / `test_section` scopes,
`compute_gradient` and the functional `grad` / `grad_and_loss`, over the
port's `autograd`."""
from __future__ import annotations

import functools

from .. import autograd as ag
from ..ndarray.ndarray import NDArray

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad"]


def set_is_training(is_train):
    """Set training mode and recording together; returns the previous
    training mode."""
    prev = ag.is_training()
    ag.set_training(is_train)
    ag.set_recording(is_train)
    return prev


def train_section():
    """`with train_section():` records in training mode."""
    return ag.record(train_mode=True)


def test_section():
    """`with test_section():` pauses recording, predict mode."""
    return ag.pause(train_mode=False)


mark_variables = ag.mark_variables


def backward(outputs, out_grads=None, retain_graph=False):
    return ag.backward(outputs, head_grads=out_grads,
                       retain_graph=retain_graph)


def compute_gradient(outputs):
    """Backward on the marked variables."""
    return backward(outputs)


def grad_and_loss(func, argnum=None):
    """Wrap `func` to return (gradients of the selected arguments, its
    outputs)."""

    @functools.wraps(func)
    def wrapped(*args):
        picked = (list(range(len(args))) if argnum is None
                  else ([argnum] if isinstance(argnum, int)
                        else list(argnum)))
        variables = [args[i] for i in picked]
        for x in variables:
            if not isinstance(x, NDArray):
                raise TypeError("grad requires NDArray arguments")
        for x in variables:
            x.attach_grad()
        with ag.record():
            outputs = func(*args)
        heads = outputs if isinstance(outputs, (list, tuple)) else [outputs]
        ag.backward(list(heads))
        return [x.grad for x in variables], outputs

    return wrapped


def grad(func, argnum=None):
    """Wrap `func` to return the gradients alone."""
    wrapped = grad_and_loss(func, argnum)

    @functools.wraps(func)
    def only_grad(*args):
        return wrapped(*args)[0]

    return only_grad
