"""Control flow over NDArrays (`incubator_mxnet_tpu/contrib/
control_flow.py`): `foreach`, `while_loop` and `cond`.

Each is a Python loop or branch over the port's recorded ops, so under
`autograd.record()` the gradient flows through every step taken (JAX
lowers them to `lax.scan` / `lax.cond`). `while_loop` keeps JAX's
shapes: the per-step outputs are stacked to `max_iterations` rows, the
rows past the last step zero.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..ndarray.ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    return [x] if isinstance(x, NDArray) else list(x)


def _stack(rows):
    from .. import ndarray as nd

    return nd.stack(*rows, axis=0)


def foreach(body, data, init_states):
    """Run `body(x_t, states) -> (out_t, new_states)` over axis 0 of
    `data`; returns (outputs stacked over t, final states)."""
    single_data = isinstance(data, NDArray)
    datas = _as_list(data)
    single_state = isinstance(init_states, NDArray)
    states = _as_list(init_states)
    steps = datas[0].shape[0]
    if steps == 0:
        raise ValueError("foreach: data has no steps along axis 0")
    outs, single_out = [], True
    for t in range(steps):
        xs = [d[t] for d in datas]
        out, new_states = body(xs[0] if single_data else xs,
                               states[0] if single_state else states)
        single_out = isinstance(out, NDArray)
        outs.append(_as_list(out))
        states = _as_list(new_states)
    stacked = [_stack([o[k] for o in outs]) for k in range(len(outs[0]))]
    return (stacked[0] if single_out else stacked,
            states[0] if single_state else states)


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """Run `func(vars) -> (out, new_vars)` while `cond_fn(vars)` holds, at
    most `max_iterations` times; returns (outputs stacked to
    max_iterations rows, zero past the last step, final vars)."""
    if max_iterations is None:
        raise ValueError("while_loop needs max_iterations (the outputs "
                         "have max_iterations rows)")
    single = isinstance(loop_vars, NDArray)
    lvars = _as_list(loop_vars)
    outs, single_out = [], True
    for _ in range(int(max_iterations)):
        c = cond_fn(lvars[0] if single else lvars)
        if not bool(c.asnumpy().reshape(()) if isinstance(c, NDArray)
                    else c):
            break
        out, new_vars = func(lvars[0] if single else lvars)
        single_out = isinstance(out, NDArray)
        outs.append(_as_list(out))
        lvars = _as_list(new_vars)
    if not outs:  # no step: the outputs' shapes from one unrecorded call
        with autograd.pause():
            probe, _ = func(lvars[0] if single else lvars)
        single_out = isinstance(probe, NDArray)
        shapes = [(o.shape, o._data) for o in _as_list(probe)]
    else:
        shapes = [(o.shape, o._data) for o in outs[0]]
    pad = int(max_iterations) - len(outs)
    stacked = []
    for k, (shape, like) in enumerate(shapes):
        rows = [o[k] for o in outs]
        zeros = NDArray._from_data(torch.zeros(
            (pad,) + tuple(shape), dtype=like.dtype, device=like.device))
        if not rows:
            stacked.append(zeros)
            continue
        full = _stack(rows)
        if pad:
            from .. import ndarray as nd

            full = nd.concat(full, zeros, dim=0)
        stacked.append(full)
    return (stacked[0] if single_out else stacked,
            lvars[0] if single else lvars)


def cond(pred, then_func, else_func, inputs=None):
    """`then_func(*inputs)` if `pred` (a one-element NDArray) holds, else
    `else_func(*inputs)`."""
    ins = _as_list(inputs) if inputs is not None else []
    p = bool(pred.asnumpy().reshape(())) if isinstance(pred, NDArray) \
        else bool(pred)
    fn = then_func if p else else_func
    out = fn(*ins) if ins else fn()
    outs = _as_list(out)
    return outs if len(outs) > 1 else outs[0]
