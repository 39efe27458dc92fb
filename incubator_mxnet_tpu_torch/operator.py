"""Custom operators written in Python (`incubator_mxnet_tpu/operator.py`):
`CustomOp` / `CustomOpProp`, `register` and the `nd.Custom` dispatcher.

The user's `forward` and `backward` run on the host over CPU NDArrays
(numpy underneath) inside a `torch.autograd.Function`, so a custom op
records under `autograd.record()` and its gradient is the user's
`backward` (the JAX package runs them through `jax.pure_callback` in a
`custom_vjp`). Outputs come back on the inputs' device as float32, the
shapes `infer_shape` gives.
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .ndarray.ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register", "get_custom_op",
           "Custom"]

_CUSTOM_REGISTRY = {}
_CUSTOM_CALLS: dict = {}


def _host(x):
    """A CPU NDArray over a copy of tensor or array `x`."""
    if torch.is_tensor(x):
        return NDArray._from_data(x.detach().to("cpu", copy=True))
    return NDArray._from_data(torch.as_tensor(np.array(x)))


class CustomOp:
    """Base class of a custom operator's body."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write `src` into `dst` by `req` (write, inplace, add, null)."""
        val = src._data if isinstance(src, NDArray) else torch.as_tensor(
            np.asarray(src))
        if req in ("write", "inplace", None):
            dst._data = val
        elif req == "add":
            dst._data = dst._data + val.to(dst._data.device)


class CustomOpProp:
    """A custom operator's metadata."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


class _HostCall(torch.autograd.Function):
    """The user's forward on the host; its backward is the user's."""

    @staticmethod
    def forward(ctx, op, out_shapes, *datas):
        ins = [_host(d) for d in datas]
        outs = [_host(np.zeros(s, np.float32)) for s in out_shapes]
        op.forward(True, ["write"] * len(outs), ins, outs, [])
        dev = datas[0].device if datas else torch.device("cpu")
        results = tuple(torch.as_tensor(o.asnumpy(), dtype=torch.float32,
                                        device=dev) for o in outs)
        ctx.op = op
        ctx.save_for_backward(*datas, *results)
        ctx.n_in = len(datas)
        return results

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        datas, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        ins = [_host(d) for d in datas]
        igrads = [_host(np.zeros(tuple(d.shape), np.float32)) for d in datas]
        ctx.op.backward(["write"] * len(ins), [_host(g) for g in grads], ins,
                        [_host(o) for o in outs], igrads, [])
        return (None, None) + tuple(
            torch.as_tensor(g.asnumpy(), device=d.device).to(d.dtype)
            for g, d in zip(igrads, datas))


def register(reg_name):
    """Register a CustomOpProp subclass under `reg_name` (`nd.Custom(...,
    op_type=reg_name)`, `nd.Custom_<reg_name>`)."""

    def deco(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        _register_custom_as_op(reg_name, prop_cls)
        return prop_cls

    return deco


def get_custom_op(name):
    return _CUSTOM_REGISTRY[name]


def _register_custom_as_op(reg_name, prop_cls):
    def call(*inputs, **kwargs):
        prop = prop_cls(**kwargs)
        arrays = [a if isinstance(a, NDArray) else NDArray(a)
                  for a in inputs]
        in_shapes = [a.shape for a in arrays]
        _, out_shapes, _ = prop.infer_shape(list(in_shapes))
        op = prop.create_operator(None, in_shapes, [a.dtype for a in arrays])
        out_shapes = [tuple(s) for s in out_shapes]
        results = autograd.invoke_recorded(
            lambda *ts: _HostCall.apply(op, out_shapes, *ts), arrays,
            name=f"custom:{reg_name}")
        return results if len(results) > 1 else results[0]

    from . import ndarray as nd_mod

    setattr(nd_mod, f"Custom_{reg_name}", call)
    _CUSTOM_CALLS[reg_name] = call
    return call


def Custom(*inputs, op_type=None, **kwargs):
    """`nd.Custom(data, ..., op_type='my_op')`: the registered op
    `op_type` over the inputs."""
    if op_type is None:
        raise TypeError("nd.Custom requires op_type=<registered name>")
    if op_type not in _CUSTOM_CALLS:
        raise KeyError(f"no custom op '{op_type}' registered "
                       f"(have: {sorted(_CUSTOM_CALLS)})")
    return _CUSTOM_CALLS[op_type](*inputs, **kwargs)
