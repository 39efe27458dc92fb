"""Imperative autograd (`incubator_mxnet_tpu/autograd.py`) over
`torch.autograd`: the record / pause / train / predict scopes, variables
with gradient buffers, `backward` and `grad`. There is no tape of the
port's own: inside `record()` ops run with torch's grad mode on, so
torch records them; outside it they run under `torch.no_grad()`.

A variable is an NDArray marked with `attach_grad` / `mark_variables`
(a gluon `Parameter`'s data is one): its tensor becomes a leaf that
requires grad, so it must be marked before the recorded ops, as in the
reference. `backward` takes the gradients of the heads with respect to
every live variable in one `torch.autograd.grad` call and writes each
into the variable's own buffer by its `grad_req`: "write" overwrites,
"add" accumulates, "null" leaves it alone (torch's own `.grad`
accumulation is never used). `grad(create_graph=True)` keeps the
gradient computation recorded, for second derivatives.
"""
from __future__ import annotations

import threading
import warnings
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "invoke_recorded"]

_STATE = threading.local()
# id -> NDArray of every live variable (marked with a gradient buffer)
_VARIABLES = weakref.WeakValueDictionary()
_NDArray = None


def _nd_cls():
    global _NDArray
    if _NDArray is None:
        from .ndarray.ndarray import NDArray
        _NDArray = NDArray
    return _NDArray


def _state():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
        _STATE.record_gen = 0
    return _STATE


def is_recording():
    return _state().recording


def is_training():
    return _state().training


def set_recording(is_record):
    prev = _state().recording
    _STATE.recording = bool(is_record)
    return prev


def set_training(train_mode_):
    prev = _state().training
    _STATE.training = bool(train_mode_)
    return prev


class _AutogradScope:
    def __init__(self, recording=None, training=None):
        self._recording = recording
        self._training = training

    def __enter__(self):
        if self._recording:
            _state().record_gen += 1
        if self._recording is not None:
            self._prev_rec = set_recording(self._recording)
        if self._training is not None:
            self._prev_train = set_training(self._training)
        return self

    def __exit__(self, *exc):
        if self._recording is not None:
            set_recording(self._prev_rec)
        if self._training is not None:
            set_training(self._prev_train)


def record(train_mode=True):  # noqa: A002 - reference API name
    """Scope: record ops for autograd, in training mode by default."""
    return _AutogradScope(recording=True, training=train_mode)


def pause(train_mode=False):  # noqa: A002
    return _AutogradScope(recording=False, training=train_mode)


def train_mode():
    return _AutogradScope(training=True)


def predict_mode():
    return _AutogradScope(training=False)


def invoke_recorded(fn, input_arrays, name=""):
    """Run `fn(*tensors) -> tensor | tuple` on the arrays' tensors, with
    torch recording it only inside `record()`. Returns a list of
    NDArrays. Outside `record()` a result that shares its input's memory
    (a view) is copied, so arrays keep value semantics."""
    NDArray = _nd_cls()
    datas = [a._data if isinstance(a, NDArray) else a for a in input_arrays]
    recording = is_recording()
    with torch.set_grad_enabled(recording):
        out = fn(*datas)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not recording:
        outs = _unaliased(outs, datas)
    return [NDArray._from_data(o) for o in outs]


def _unaliased(outs, datas):
    ptrs = {d.untyped_storage().data_ptr() for d in datas
            if torch.is_tensor(d)}
    return [o.clone() if torch.is_tensor(o)
            and o.untyped_storage().data_ptr() in ptrs else o for o in outs]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark `variables` (NDArrays) as leaves with the gradient buffers
    `gradients`: each tensor is detached and, unless its grad_req is
    "null", set to require grad."""
    NDArray = _nd_cls()
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        d = v._data.detach()
        if req != "null" and d.is_floating_point():
            d.requires_grad_(True)
        v._data = d
        v._grad = g
        v._grad_req = req
        _VARIABLES[id(v)] = v


def _heads(heads, head_grads):
    NDArray = _nd_cls()
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue
        if isinstance(hg, NDArray):
            g = hg._data
        elif hg is None:
            g = torch.ones_like(h._data)
        else:
            g = torch.as_tensor(hg, dtype=h._data.dtype,
                                device=h._data.device)
        outs.append(h._data)
        grads.append(g)
    return outs, grads


def backward(heads, head_grads=None, retain_graph=False,
             train_mode=True):  # noqa: A002
    """Gradients of `heads` with respect to every marked variable, written
    into each variable's buffer by its grad_req."""
    outs, grads = _heads(heads, head_grads)
    if not outs:
        return
    variables = [v for v in list(_VARIABLES.values())
                 if v._grad is not None and v._grad_req != "null"
                 and v._data.requires_grad and v._data.is_leaf]
    if not variables:
        return
    got = torch.autograd.grad(outs, [v._data for v in variables],
                              grad_outputs=grads, retain_graph=retain_graph,
                              allow_unused=True)
    gen = _state().record_gen
    for v, g in zip(variables, got):
        if g is None:
            continue
        buf = v._grad
        if v._grad_req == "add":
            buf._data = buf._data + g.to(buf._data.dtype)
            continue
        if v._grad_gen == gen:
            warnings.warn(
                "gradient overwritten by a second backward() in the "
                "same record() scope; for sharded losses use "
                "autograd.backward([loss1, loss2, ...]) (accumulates "
                "in one pass) or attach_grad(grad_req='add')",
                RuntimeWarning, stacklevel=2)
        buf._data = g.to(buf._data.dtype).reshape(buf._data.shape)
        v._grad_gen = gen


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):  # noqa: A002
    """Gradients of `heads` with respect to `variables` (marked NDArrays),
    returned as new NDArrays without touching the variables' buffers;
    `create_graph=True` records the computation for a second backward."""
    NDArray = _nd_cls()
    single = isinstance(variables, NDArray)
    variables = [variables] if single else list(variables)
    outs, grads = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    live = [v for v in variables if v._data.requires_grad]
    got = dict.fromkeys(map(id, variables))
    if outs and live:
        with torch.set_grad_enabled(create_graph):
            res = torch.autograd.grad(outs, [v._data for v in live],
                                      grad_outputs=grads,
                                      retain_graph=retain_graph,
                                      create_graph=create_graph,
                                      allow_unused=True)
        got.update({id(v): g for v, g in zip(live, res)})
    out = [NDArray._from_data(got[id(v)] if got[id(v)] is not None
                              else torch.zeros_like(v._data))
           for v in variables]
    return out[0] if single else out


def get_symbol(x):
    raise NotImplementedError("tracing an eager graph to a Symbol is not "
                              "ported (the symbolic slice)")
