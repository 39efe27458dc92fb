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

`sparse_embedding` is the lookup whose recorded weight gradient is row
sparse: it gathers the batch's unique rows into a fresh leaf (a "tap" of
the weight) and looks the ids up in that block, so the gradient torch
computes is the (unique rows, width) block, with duplicate ids summed by
the embedding backward (sorted on the card, the same order every run).
`backward` turns each tap's gradient into a `RowSparseNDArray` over the
unique ids, and the weight's buffer becomes that array, as in the JAX
package; a dense gradient of the same weight in the same pass is added
to it densely.
"""
from __future__ import annotations

import threading
import warnings
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "invoke_recorded",
           "sparse_embedding"]

_STATE = threading.local()
# id -> NDArray of every live variable (marked with a gradient buffer)
_VARIABLES = weakref.WeakValueDictionary()
# the row-sparse taps of recorded sparse_embedding lookups: (weakref to
# the weight NDArray, weakref to the gathered-rows leaf, unique ids,
# weight shape); a tap dies with its graph
_TAPS = []
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


def sparse_embedding(x, weight, input_dim, output_dim):
    """Look the ids `x` (a tensor) up in `weight` (an NDArray, an autograd
    variable) and return the (*x.shape, output_dim) tensor. Inside
    `record()` the weight's gradient is recorded row sparse: only the
    batch's unique ids appear in it, duplicates summed."""
    w = weight._data
    idx = x.reshape(-1).to(device=w.device, dtype=torch.int64)
    shape = tuple(x.shape) + (int(output_dim),)
    if not is_recording():
        with torch.no_grad():
            return torch.nn.functional.embedding(idx, w).reshape(shape)
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    rows = w.detach()[uniq].requires_grad_(True)
    _TAPS[:] = [t for t in _TAPS if t[1]() is not None]
    _TAPS.append((weakref.ref(weight), weakref.ref(rows), uniq,
                  (int(input_dim), int(output_dim))))
    with torch.enable_grad():
        return torch.nn.functional.embedding(inv, rows).reshape(shape)


def _live_taps():
    """[(weight NDArray, rows leaf, unique ids, shape)] of the live taps."""
    out = []
    for wref, rref, uniq, shape in _TAPS:
        w, rows = wref(), rref()
        if w is not None and rows is not None:
            out.append((w, rows, uniq, shape))
    return out


def _sparse_grads(taps, got):
    """{id(weight): RowSparseNDArray} from the taps' block gradients (two
    taps of one weight add sparsely)."""
    from .ndarray.sparse import RowSparseNDArray, add as sparse_add

    out = {}
    for (w, _rows, uniq, shape), g in zip(taps, got):
        if g is None:
            continue
        rsp = RowSparseNDArray(_nd_cls()._from_data(g),
                               _nd_cls()._from_data(uniq), shape,
                               unique=True)
        prev = out.get(id(w))
        out[id(w)] = rsp if prev is None else sparse_add(prev, rsp)
    return out


def _forget_taps(taps, got):
    """Drop the taps this backward reached (their gradient came back); a
    tap of another graph recorded in the same scope stays for its own
    backward."""
    used = {id(t[1]) for t, g in zip(taps, got) if g is not None}
    _TAPS[:] = [t for t in _TAPS if t[1]() is not None
                and id(t[1]()) not in used]


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
    live = {id(v) for v in variables}
    taps = [t for t in _live_taps() if id(t[0]) in live]
    if not variables:
        return
    got = torch.autograd.grad(
        outs, [v._data for v in variables] + [t[1] for t in taps],
        grad_outputs=grads, retain_graph=retain_graph, allow_unused=True)
    sparse = _sparse_grads(taps, got[len(variables):])
    if not retain_graph:
        _forget_taps(taps, got[len(variables):])
    gen = _state().record_gen
    for v, g in zip(variables, got):
        sp = sparse.get(id(v))
        if sp is not None:
            if g is not None:  # a dense use too: the sum is dense
                g = g + sp.todense()._data
            else:
                _write_sparse(v, sp, gen)
                continue
        if g is None:
            continue
        buf = v._grad
        if _is_sparse(buf):
            # a dense gradient displaces the sparse buffer
            prev = buf.todense()._data if v._grad_req == "add" else None
            buf = v._grad = _nd_cls()._from_data(
                prev if prev is not None else torch.zeros_like(v._data))
        if v._grad_req == "add":
            buf._data = buf._data + g.to(buf._data.dtype)
            continue
        _warn_overwrite(v, gen)
        buf._data = g.to(buf._data.dtype).reshape(buf._data.shape)


def _is_sparse(x):
    from .ndarray.sparse import BaseSparseNDArray
    return isinstance(x, BaseSparseNDArray)


def _warn_overwrite(v, gen):
    """Warn when a "write" gradient replaces one written by an earlier
    backward of the same record() scope; mark the buffer written."""
    if v._grad_gen == gen:
        warnings.warn(
            "gradient overwritten by a second backward() in the "
            "same record() scope; for sharded losses use "
            "autograd.backward([loss1, loss2, ...]) (accumulates "
            "in one pass) or attach_grad(grad_req='add')",
            RuntimeWarning, stacklevel=3)
    v._grad_gen = gen


def _write_sparse(v, sp, gen):
    """Write a row-sparse gradient by the variable's grad_req: "write"
    makes it the buffer, "add" adds it (sparsely to a sparse buffer)."""
    from .ndarray.sparse import add as sparse_add

    buf = v._grad
    if v._grad_req != "add":
        _warn_overwrite(v, gen)
        v._grad = sp
    elif _is_sparse(buf):
        v._grad = sparse_add(buf, sp)
    else:
        buf._data = buf._data + sp.todense()._data.to(buf._data.dtype)


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
    ids = {id(v) for v in live}
    taps = [t for t in _live_taps() if id(t[0]) in ids]
    got = dict.fromkeys(map(id, variables))
    sparse = {}
    if outs and live:
        with torch.set_grad_enabled(create_graph):
            res = torch.autograd.grad(
                outs, [v._data for v in live] + [t[1] for t in taps],
                grad_outputs=grads, retain_graph=retain_graph,
                create_graph=create_graph, allow_unused=True)
        got.update({id(v): g for v, g in zip(live, res)})
        sparse = _sparse_grads(taps, res[len(live):])
    out = []
    for v in variables:
        g, sp = got[id(v)], sparse.get(id(v))
        if sp is not None and g is None:
            out.append(sp)
            continue
        if g is None:
            g = torch.zeros_like(v._data)
        if sp is not None:
            g = g + sp.todense()._data
        out.append(NDArray._from_data(g))
    return out[0] if single else out


def get_symbol(x):
    raise NotImplementedError("tracing an eager graph to a Symbol is not "
                              "ported (the symbolic slice)")
