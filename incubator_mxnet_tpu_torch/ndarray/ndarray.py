"""NDArray, the user-facing tensor (`incubator_mxnet_tpu/ndarray/ndarray.py`).

An NDArray holds one torch tensor (`_data`) and is not itself a
`torch.Tensor`: MXNet's `size` (the element count), `dtype` (a numpy
dtype), `reshape` codes and elementwise `__eq__` differ from torch's.
Every op routes through `autograd.invoke_recorded` (or the registry's
`invoke`): inside `autograd.record()` torch's autograd records it, and
outside it the op runs under `torch.no_grad()`.

Values keep the reference's semantics: an op whose result would alias
its input (a reshape, a basic index) hands back a copy outside
`record()`, and the in-place operators (`x[k] = v`, `x += y`) write in
place outside `record()` and rebind the array to a new tensor inside
it, so a recorded graph never sees a later write. `wait_to_read`
synchronises the array's stream. `tostype("row_sparse" | "csr")` converts
through `ndarray.sparse`. Not ported here: DLPack.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..base import dtype_np, dtype_torch
from ..context import Context, context_of, to_device

__all__ = ["NDArray", "array", "waitall", "concatenate"]


def _key(key):
    """A torch indexing key for an NDArray / numpy / tuple key."""
    if isinstance(key, NDArray):
        d = key._data
        return d.to(torch.int64) if d.is_floating_point() else d
    if isinstance(key, np.ndarray):
        return torch.from_numpy(key.astype(np.int64) if key.dtype.kind == "f"
                                else key)
    if isinstance(key, tuple):
        return tuple(_key(k) for k in key)
    return key


def _operand(other, like):
    """A scalar stays a Python number; arrays become tensors on `like`'s
    device."""
    if isinstance(other, NDArray):
        return other._data
    if isinstance(other, (np.ndarray, list)):
        return torch.as_tensor(np.asarray(other), device=like.device)
    return other


class NDArray:
    """Dense tensor handle over a torch tensor."""

    __slots__ = ("_data", "_grad", "_grad_req", "_grad_gen", "__weakref__")

    # win against numpy in mixed dunder dispatch
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not torch.is_tensor(data):
            data = torch.as_tensor(np.asarray(data))
            if ctx is None:
                ctx = Context.default_ctx()
        if dtype is not None:
            data = data.to(dtype_torch(dtype))
        if ctx is not None:
            data = data.to(to_device(ctx))
        self._data = data
        self._grad = None
        self._grad_req = "write"
        self._grad_gen = None

    @classmethod
    def _from_data(cls, data):
        out = cls.__new__(cls)
        out._data = data
        out._grad = None
        out._grad_req = "write"
        out._grad_gen = None
        return out

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return dtype_np(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        return self._grad

    # -- materialization / sync -------------------------------------------
    def asnumpy(self):
        """A blocking copy to a numpy array (bfloat16 as float32)."""
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            d = d.float()
        return d.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Block until the array's pending writes are done (its device's
        current stream)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a gradient buffer and mark the array as a variable
        (autograd.mark_variables); detaches it from any graph."""
        autograd.mark_variables(
            [self], [NDArray._from_data(torch.zeros_like(self._data))],
            grad_req)

    def detach(self):
        return NDArray._from_data(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad], retain_graph=retain_graph,
                          train_mode=train_mode)

    # -- conversion / movement --------------------------------------------
    def astype(self, dtype, copy=True):
        dt = dtype_torch(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return self._apply(lambda d: d.to(dt))

    def as_in_context(self, ctx):
        dev = to_device(ctx)
        if dev == self._data.device:
            return self
        return self._apply(lambda d: d.to(dev))

    as_in_ctx = as_in_context

    def copyto(self, other):
        """Copy into a context (a new array) or into an array (in place,
        in that array's dtype)."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                other._data.copy_(self._data.reshape(other._data.shape))
            return other
        return NDArray._from_data(self._data.detach().to(
            to_device(other), copy=True))

    def copy(self):
        return self._apply(lambda d: d.clone())

    def tostype(self, stype):
        """This array in storage type `stype` ("default" is itself)."""
        if stype == "default":
            return self
        from . import sparse
        return sparse.cast_storage(self, stype)

    def as_nd_ndarray(self):
        return self

    # -- helpers -----------------------------------------------------------
    def _apply(self, fn, *others):
        """Route a tensor-level fn through the autograd dispatcher."""
        return autograd.invoke_recorded(fn, [self, *others])[0]

    def _op(self, name, *inputs, **attrs):
        return _reg().invoke_by_name(name, [self, *inputs], attrs)

    # -- shape ops ---------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape and "shape" in kwargs:
            shape = tuple(kwargs.pop("shape"))
        return self._op("Reshape", shape=shape, **kwargs)

    def reshape_like(self, other):
        return self._apply(lambda a, b: a.reshape(b.shape), other)

    def transpose(self, axes=None):
        return self._op("transpose", axes=axes)

    def swapaxes(self, dim1, dim2):
        return self._op("SwapAxis", dim1=dim1, dim2=dim2)

    def flatten(self):
        return self._op("Flatten")

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._op("squeeze", axis=axis)

    def broadcast_to(self, shape):
        return self._apply(lambda d: torch.broadcast_to(d, tuple(shape)))

    def broadcast_like(self, other):
        return self._apply(lambda a, b: torch.broadcast_to(a, b.shape), other)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op("split", num_outputs=num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis)

    def slice(self, begin, end, step=None):
        return self._op("slice", begin=begin, end=end, step=step or ())

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", indices, axis=axis, mode=mode)

    def one_hot(self, depth, **kwargs):
        return self._op("one_hot", depth=depth, **kwargs)

    def pad(self, mode, pad_width, constant_value=0.0):
        return self._op("pad", mode=mode, pad_width=pad_width,
                        constant_value=constant_value)

    def tile(self, reps):
        return self._op("tile", reps=reps)

    def repeat(self, repeats, axis=None):
        return self._op("repeat", repeats=repeats, axis=axis)

    def flip(self, axis):
        return self._op("flip", axis=axis)

    def diag(self, k=0):
        return self._op("diag", k=k)

    # -- reductions --------------------------------------------------------
    def sum(self, axis=None, keepdims=False, **kw):
        return self._op("sum", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False, **kw):
        return self._op("mean", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._op("prod", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return self._op("max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return self._op("min", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op("argmin", axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return self._op("argsort", axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return self._op("sort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._op("topk", axis=axis, k=k, ret_typ=ret_typ,
                        is_ascend=is_ascend)

    def clip(self, a_min, a_max):
        return self._op("clip", a_min=a_min, a_max=a_max)

    def abs(self):
        return self._op("abs")

    def sign(self):
        return self._op("sign")

    def sqrt(self):
        return self._op("sqrt")

    def square(self):
        return self._op("square")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def tanh(self):
        return self._op("tanh")

    def sigmoid(self):
        return self._op("sigmoid")

    def relu(self):
        return self._op("relu")

    def softmax(self, axis=-1):
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op("log_softmax", axis=axis)

    def round(self):
        return self._op("round")

    def floor(self):
        return self._op("floor")

    def ceil(self):
        return self._op("ceil")

    def dot(self, other, transpose_a=False, transpose_b=False):
        return self._op("dot", other, transpose_a=transpose_a,
                        transpose_b=transpose_b)

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, fn):
        if isinstance(other, NDArray):
            return autograd.invoke_recorded(fn, [self, other])[0]
        o = _operand(other, self._data)
        return autograd.invoke_recorded(lambda a: fn(a, o), [self])[0]

    def _rbinop(self, other, fn):
        o = _operand(other, self._data)
        return autograd.invoke_recorded(lambda a: fn(o, a), [self])[0]

    def __add__(self, other):
        return self._binop(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, torch.sub)

    def __rsub__(self, other):
        return self._rbinop(other, lambda o, a: o - a)

    def __mul__(self, other):
        return self._binop(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, torch.div)

    def __rtruediv__(self, other):
        return self._rbinop(other, lambda o, a: o / a)

    def __mod__(self, other):
        return self._binop(other, torch.remainder)

    def __rmod__(self, other):
        return self._rbinop(other, lambda o, a: torch.remainder(
            torch.as_tensor(o, dtype=a.dtype, device=a.device), a))

    def __pow__(self, other):
        return self._binop(other, torch.pow)

    def __rpow__(self, other):
        return self._rbinop(other, torch.pow)

    def __matmul__(self, other):
        return self._binop(other, torch.matmul)

    def __neg__(self):
        return self._apply(torch.neg)

    def __abs__(self):
        return self._apply(torch.abs)

    def _inplace(self, other, fn):
        o = _operand(other, self._data)
        if autograd.is_recording():
            self._data = fn(self._data, o)
        else:
            with torch.no_grad():
                self._data.copy_(fn(self._data, o))
        return self

    def __iadd__(self, other):
        return self._inplace(other, torch.add)

    def __isub__(self, other):
        return self._inplace(other, torch.sub)

    def __imul__(self, other):
        return self._inplace(other, torch.mul)

    def __itruediv__(self, other):
        return self._inplace(other, torch.div)

    def _cmp(self, other, fn):
        o = _operand(other, self._data)
        with torch.no_grad():
            return NDArray._from_data(fn(self._data, o).to(self._data.dtype))

    def __eq__(self, other):
        if other is None:
            return False
        return self._cmp(other, torch.eq)

    def __ne__(self, other):
        if other is None:
            return True
        return self._cmp(other, torch.ne)

    def __lt__(self, other):
        return self._cmp(other, torch.lt)

    def __le__(self, other):
        return self._cmp(other, torch.le)

    def __gt__(self, other):
        return self._cmp(other, torch.gt)

    def __ge__(self, other):
        return self._cmp(other, torch.ge)

    def __hash__(self):
        return id(self)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self):
        return self.shape[0] if self.ndim else 0

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        k = _key(key)
        return autograd.invoke_recorded(lambda d: d[k], [self])[0]

    def __setitem__(self, key, value):
        k = _key(key)
        v = _operand(value, self._data)
        if autograd.is_recording():
            new = self._data.clone()
            new[k] = v
            self._data = new
            return
        with torch.no_grad():
            self._data[k] = v

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a


_REGISTER = None


def _reg():
    """The register module, cached after first use (register imports this
    module)."""
    global _REGISTER
    if _REGISTER is None:
        from . import register
        _REGISTER = register
    return _REGISTER


def array(source_array, ctx=None, dtype=None):
    """A new NDArray (always a copy) from any array-like, on `ctx` (None:
    the current context, the card unless a `with cpu():` scope says
    otherwise). Python lists and scalars default to float32; numpy arrays
    keep their dtype."""
    if isinstance(source_array, NDArray):
        data = source_array._data.detach()
    elif torch.is_tensor(source_array):
        data = source_array.detach()
    elif isinstance(source_array, np.ndarray):
        data = torch.from_numpy(
            np.ascontiguousarray(source_array).reshape(source_array.shape))
    else:
        data = torch.as_tensor(np.asarray(
            source_array, dtype=dtype_np(dtype) if dtype else np.float32))
    data = data.to(to_device(ctx), copy=True)
    if dtype is not None:
        data = data.to(dtype_torch(dtype))
    return NDArray._from_data(data)


def concatenate(arrays, axis=0):
    return autograd.invoke_recorded(lambda *xs: torch.cat(xs, dim=axis),
                                    list(arrays))[0]


def waitall():
    """Block until all queued device work is done."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
