"""Neural-network operators that the gluon ResNet dispatches, on torch
tensors, with the JAX package's names, attributes and semantics
(`incubator_mxnet_tpu/ops/nn.py`, `pick` from `ops/tensor.py`).

Convolutions, pooling and products go to PyTorch (cuDNN on the card), as
the JAX package leaves them to XLA; the normalisation is written out in
tensor ops so that its statistics follow the JAX package: biased batch
variance, moving stats `moving * momentum + batch * (1 - momentum)`.
(`torch.nn.functional.batch_norm` is not used for that: it writes the
unbiased variance into its running stats, and its `momentum` is one
minus MXNet's.)

Channels-last layouts (`layout="NHWC"`) keep the weight in the reference's
OIHW layout. The NHWC input is handed to `conv2d` as its NCHW
`permute(0, 3, 1, 2)` view, which is already channels-last in memory, so
PyTorch picks its channels-last algorithms and the output, permuted back,
is a contiguous NHWC tensor with no copy on either side.

A training-mode BatchNorm's new moving stats reach the running-stat
tensors through `write_moving`: in place, or, inside
`deferred_moving_writes(sink)`, into `sink` for the caller to write once
(a train step whose forward may be recomputed, as the JAX step gets them
back as aux outputs and a recomputed forward writes nothing).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as tF

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "batch_moments", "moving_update", "write_moving",
           "moving_sink", "deferred_moving_writes", "activation", "flatten",
           "log_softmax", "pick"]

_MOVING = threading.local()


def fully_connected(data, weight, bias=None, *, num_hidden=None,
                    no_bias=False, flatten=True):
    """y = x W^T + b; x flattened to (N, -1) first when `flatten`."""
    x = data.reshape(data.shape[0], -1) if flatten and data.dim() > 2 \
        else data
    if x.dtype != weight.dtype:
        x = x.to(weight.dtype)
    y = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        y = y + bias
    return y


def _tup(v, n):
    if v is None or v == ():
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t if len(t) == n else t + (t[-1],) * (n - len(t))


def _channels_last(layout, nd):
    sp = "DHW"[3 - nd:]
    return layout is not None and layout == f"N{sp}C"


def _to_nc(x, nd):
    """The NC* view of a channels-last tensor (no copy)."""
    return x.permute(0, nd + 1, *range(1, nd + 1))


def _from_nc(x, nd):
    return x.permute(0, *range(2, nd + 2), 1)


_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}


def convolution(data, weight, bias=None, *, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, workspace=1024, cudnn_tune=None,
                cudnn_off=False, layout=None):
    """N-d convolution, weight (O, I/group, *kernel); NC(D)HW data, or
    N(D)HWC with `layout` (the output in the same layout)."""
    nd = data.dim() - 2
    if data.dtype != weight.dtype:
        data = data.to(weight.dtype)
    last = _channels_last(layout, nd)
    x = _to_nc(data, nd) if last else data
    p = _tup(pad, nd) if pad is not None else (0,) * nd
    out = _CONV[nd](x, weight, None, _tup(stride, nd), p, _tup(dilate, nd),
                    num_group)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return _from_nc(out, nd) if last else out


_POOL = {
    "max": {1: tF.max_pool1d, 2: tF.max_pool2d, 3: tF.max_pool3d},
    "avg": {1: tF.avg_pool1d, 2: tF.avg_pool2d, 3: tF.avg_pool3d},
}


def pooling(data, *, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, cudnn_off=False, layout=None,
            p_value=2):
    """Max / avg pooling, MXNet's padding conventions: `valid`
    floors the window count, `full` pads the high side until the last
    window fits (a window wholly past the input gives the lowest finite
    value for max, as the reference leaves there). An unset stride is 1.
    `layout='N{sp}C'` pools channels-last data."""
    nd = data.dim() - 2
    last = _channels_last(layout, nd)
    spatial = tuple(range(1, 1 + nd)) if last else tuple(range(2, 2 + nd))
    if pool_type not in ("max", "avg"):
        raise NotImplementedError(f"pool_type {pool_type!r} is not ported")
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        return data.mean(dim=spatial, keepdim=True)
    k = _tup(kernel, nd)
    s = _tup(stride, nd) if stride is not None else (1,) * nd
    p = _tup(pad, nd) if pad is not None else (0,) * nd
    x = _to_nc(data, nd) if last else data
    extra, empty_window = [0] * nd, False
    if pooling_convention == "full":
        for i in range(nd):
            dim = x.shape[2 + i]
            in_sz = dim + 2 * p[i]
            rem = (in_sz - k[i]) % s[i]
            extra[i] = (s[i] - rem) % s[i] if rem else 0
            n_out = 1 + (in_sz - k[i] + extra[i]) // s[i]
            empty_window |= (n_out - 1) * s[i] >= p[i] + dim
    avg, count = _POOL["avg"][nd], int(torch.tensor(k).prod())
    live = None
    if any(extra) or any(2 * pi > ki for pi, ki in zip(p, k)):
        # padding that torch's pooling does not take: pad explicitly
        widths = []
        for i in reversed(range(nd)):
            widths += [p[i], p[i] + extra[i]]
        if pool_type == "avg" and not count_include_pad:
            live = avg(tF.pad(torch.ones_like(x[:1, :1]), widths), k, s) \
                * count
        x = tF.pad(x, widths, value=float("-inf") if pool_type == "max"
                   else 0.0)
        p = (0,) * nd
    if pool_type == "max":
        out = _POOL["max"][nd](x, k, s, p)
        if empty_window:
            out = torch.where(torch.isneginf(out),
                              torch.finfo(out.dtype).min, out)
    elif live is not None:
        out = avg(x, k, s, p) * count / live
    else:
        out = avg(x, k, s, p, count_include_pad=count_include_pad)
    return _from_nc(out, nd) if last else out


def batch_moments(data, axis):
    """(mean, biased variance) over every axis but `axis`, in at least
    float32, as the JAX BatchNorm takes them (`jnp.mean`, `jnp.var`)."""
    stat_dt = torch.promote_types(data.dtype, torch.float32)
    xf = data.to(stat_dt)
    dims = tuple(i for i in range(data.dim()) if i != axis % data.dim())
    return xf.mean(dim=dims), xf.var(dim=dims, unbiased=False)


def moving_update(moving_mean, moving_var, mean, var, momentum):
    """New moving stats: moving * momentum + batch * (1 - momentum),
    without gradient."""
    mean, var = mean.detach(), var.detach()
    return (moving_mean * momentum + mean.to(moving_mean.dtype)
            * (1 - momentum),
            moving_var * momentum + var.to(moving_var.dtype)
            * (1 - momentum))


def write_moving(target, value):
    """Write a new moving stat `value` into `target` (without gradient), or
    record it in the calling thread's deferral sink."""
    sink = getattr(_MOVING, "sink", None)
    if sink is not None:
        sink[id(target)] = (target, value.detach())
        return
    with torch.no_grad():
        target.copy_(value)


def moving_sink():
    """The calling thread's deferral sink, or None (writes go in place)."""
    return getattr(_MOVING, "sink", None)


@contextlib.contextmanager
def deferred_moving_writes(sink):
    """Within the context the calling thread's `write_moving` calls record
    {id(target): (target, value)} in `sink` (the last value per target)
    and write nothing; a `sink` of None writes in place."""
    prev = getattr(_MOVING, "sink", None)
    _MOVING.sink = sink
    try:
        yield sink
    finally:
        _MOVING.sink = prev


def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _training=False):
    """Batch normalization over `axis`. In training mode (and without
    `use_global_stats`) the batch's biased moments normalise and the
    return is (out, new_moving_mean, new_moving_var); otherwise the
    moving stats normalise and the return is out. Statistics in at least
    float32, out in the data's dtype."""
    if output_mean_var:
        raise NotImplementedError(
            "BatchNorm output_mean_var=True is not supported: read the "
            "updated moving stats instead")
    ax = axis % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    stat_dt = torch.promote_types(data.dtype, torch.float32)
    xf = data.to(stat_dt)
    if _training and not use_global_stats:
        mean, var = batch_moments(data, ax)
        new_mean, new_var = moving_update(moving_mean, moving_var, mean, var,
                                          momentum)
    else:
        mean, var = moving_mean.to(stat_dt), moving_var.to(stat_dt)
        new_mean, new_var = moving_mean, moving_var
    x_hat = (xf - mean.reshape(bshape)) * torch.rsqrt(var.reshape(bshape)
                                                      + eps)
    out = (x_hat * g.reshape(bshape).to(stat_dt)
           + beta.reshape(bshape).to(stat_dt)).to(data.dtype)
    if _training:
        return out, new_mean, new_var
    return out


def activation(data, *, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return tF.softplus(data)
    if act_type == "softsign":
        return tF.softsign(data)
    raise ValueError(f"unknown act_type {act_type}")


def flatten(data):
    """Collapse all dims after the first into one."""
    return data.reshape(data.shape[0], -1)


def log_softmax(data, *, axis=-1, temperature=None):
    """log(softmax(data)) over `axis`, float32 math for narrower inputs,
    returned in the input's dtype."""
    x = data / temperature if temperature else data
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.log_softmax(x.float(), dim=axis).to(x.dtype)
    return torch.log_softmax(x, dim=axis)


def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """One element per row along `axis` at `index` (indices clipped to the
    axis, or wrapped with mode='wrap')."""
    ax = axis % data.dim()
    idx = index.to(torch.int64)
    if mode == "wrap":
        idx = torch.remainder(idx, data.shape[ax])
    else:
        idx = idx.clamp(0, data.shape[ax] - 1)
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)
