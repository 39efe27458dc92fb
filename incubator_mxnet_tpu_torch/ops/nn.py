"""Neural-network operators on torch tensors, registered under the JAX
package's names with its attributes and semantics
(`incubator_mxnet_tpu/ops/nn.py`: its 27 ops under its 33 names, and
`GroupNorm`, JAX's `ops/contrib_ops.py` op, which the gluon layer
needs).

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

The fused `RNN` op is a Python loop over time that follows JAX's
`lax.scan` step for step, with each layer's and direction's input
projection for all T steps hoisted into one matmul (the same product);
it never goes through cuDNN's fused RNN, whose dropout would draw from
cuDNN's generator and which has no state clip. `CTCLoss` is optax's
log-space forward recursion (the one JAX's op calls), with optax's
`log_epsilon` floor of -1e5 in place of -inf, in tensor ops, so that
infeasible alignments and padded positions keep finite gradients as in
JAX; torch's library CTC loss is not used.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as tF

from .registry import alias, register
from .tensor import pick  # noqa: F401  (the F namespace's `pick`)

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "batch_moments", "moving_update", "write_moving",
           "moving_sink", "deferred_moving_writes", "activation",
           "log_softmax", "pick", "deconvolution", "layer_norm",
           "instance_norm", "group_norm", "l2_normalization", "lrn",
           "leaky_relu", "softmax", "softmin", "softmax_activation",
           "softmax_cross_entropy", "softmax_output", "dropout",
           "upsampling", "im2col", "col2im", "svm_output",
           "rnn_param_size", "rnn", "ctc_loss"]

_MOVING = threading.local()


@register("FullyConnected", optional=("bias",))
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


@register("Convolution", optional=("bias",))
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


@register("Pooling")
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
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type}")
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=spatial, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=spatial, keepdim=True)
        if pool_type == "lp":
            pv = float(p_value)
            return data.abs().pow(pv).sum(dim=spatial,
                                          keepdim=True).pow(1.0 / pv)
        return data.mean(dim=spatial, keepdim=True)
    if pool_type in ("sum", "lp"):
        # the window sums: an average over zero padding times the window
        pv = float(p_value)
        src = data.abs().pow(pv) if pool_type == "lp" else data
        total = pooling(src, kernel=kernel, pool_type="avg", stride=stride,
                        pad=pad, pooling_convention=pooling_convention,
                        count_include_pad=True, layout=layout) * \
            math.prod(_tup(kernel, nd))
        return total.pow(1.0 / pv) if pool_type == "lp" else total
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


@register("BatchNorm", aux=("moving_mean", "moving_var"),
          needs_training=True)
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


@register("Activation")
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



@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None):
    """log(softmax(data)) over `axis`, float32 math for narrower inputs,
    returned in the input's dtype."""
    x = data / temperature if temperature else data
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.log_softmax(x.float(), dim=axis).to(x.dtype)
    return torch.log_softmax(x, dim=axis)




# ---------------------------------------------------------------------------
# the rest of the JAX package's nn ops
# ---------------------------------------------------------------------------

_DECONV = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


@register("Deconvolution", optional=("bias",))
def deconvolution(data, weight, bias=None, *, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True, workspace=512,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution, NC(D)HW only, weight (in_c, out_c/group,
    *kernel) as in the reference."""
    nd = data.dim() - 2
    p = _tup(pad, nd) if pad is not None else (0,) * nd
    a = _tup(adj, nd) if adj is not None else (0,) * nd
    out = _DECONV[nd](data, weight, None, _tup(stride, nd), p, a, num_group)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _moments(x, dims):
    return x.mean(dim=dims, keepdim=True), x.var(dim=dims, unbiased=False,
                                                 keepdim=True)


@register("LayerNorm",
          num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1)
def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5,
               output_mean_var=False):
    """Layer normalization over `axis`; with output_mean_var also the
    (gradient-stopped) mean and std, the axis kept as size 1."""
    mean, var = _moments(data, (axis,))
    x_hat = (data - mean) * torch.rsqrt(var + eps)
    bshape = [1] * data.dim()
    bshape[axis % data.dim()] = data.shape[axis % data.dim()]
    out = x_hat * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.detach(), torch.sqrt(var + eps).detach()
    return out


@register("InstanceNorm")
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """Instance norm over the spatial dims."""
    mean, var = _moments(data, tuple(range(2, data.dim())))
    x_hat = (data - mean) * torch.rsqrt(var + eps)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return x_hat * gamma.reshape(bshape) + beta.reshape(bshape)


@register("GroupNorm")
def group_norm(data, gamma, beta, *, num_groups=1, eps=1e-5):
    """Group normalization: data (N, C, ...) normalised over each of
    num_groups channel groups."""
    n, c = data.shape[0], data.shape[1]
    g = int(num_groups)
    x = data.reshape((n, g, c // g) + tuple(data.shape[2:]))
    mean, var = _moments(x, tuple(range(2, x.dim())))
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    bshape = (1, c) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(bshape) + beta.reshape(bshape)


@register("L2Normalization")
def l2_normalization(data, *, eps=1e-10, mode="instance"):
    """data / sqrt(sum(data^2) + eps) per instance, channel or spatial
    position."""
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.dim()))
    else:
        raise ValueError(mode)
    return data / torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                       keepdim=True) + eps)


@register("LRN")
def lrn(data, *, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response norm across channels."""
    half = nsize // 2
    padded = tF.pad(torch.square(data),
                    (0, 0) * (data.dim() - 2) + (half, half))
    window = sum(padded.narrow(1, i, data.shape[1]) for i in range(nsize))
    return data / torch.pow(knorm + (alpha / nsize) * window, beta)


@register("LeakyReLU", optional=("gamma",), needs_rng=True,
          needs_training=True)
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, _rng=None,
               _training=False):
    """leaky / prelu (a learned `gamma`) / elu / selu / gelu / rrelu."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = (gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
             if gamma.dim() == 1 else gamma)
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        a, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data > 0, data, a * torch.expm1(data))
    if act_type == "gelu":
        return tF.gelu(data, approximate="none")
    if act_type == "rrelu":
        if _training and _rng is not None:
            s = torch.empty(data.shape, dtype=data.dtype,
                            device=data.device).uniform_(
                lower_bound, upper_bound, generator=_rng)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise ValueError(f"unknown act_type {act_type}")


def _f32_softmax(data, dim):
    """softmax in at least float32, returned in the input's dtype."""
    if data.dtype in (torch.bfloat16, torch.float16):
        return torch.softmax(data.float(), dim=dim).to(data.dtype)
    return torch.softmax(data, dim=dim)


@register("softmax", optional=("length",), no_grad_inputs=("length",))
def softmax(data, length=None, *, axis=-1, temperature=None,
            use_length=None):
    """Softmax over `axis`, with optional `temperature` scaling; with
    `length`, positions at or past each row's length get 0."""
    x = data / temperature if temperature else data
    if use_length is False:
        length = None
    if length is None:
        return _f32_softmax(x, axis)
    ax = axis % x.dim()
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    mask = torch.arange(x.shape[ax], device=x.device).reshape(shape) < \
        length.to(torch.int64).unsqueeze(ax)
    out = _f32_softmax(torch.where(mask, x, torch.full(
        (), -math.inf, dtype=x.dtype, device=x.device)), axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


@register("softmin")
def softmin(data, *, axis=-1):
    """Softmax of the negated input."""
    return _f32_softmax(-data, axis)


@register("SoftmaxActivation")
def softmax_activation(data, *, mode="instance"):
    """Softmax over channels (mode 'channel') or the whole instance."""
    if mode == "channel":
        return _f32_softmax(data, 1)
    return _f32_softmax(data.reshape(data.shape[0], -1), -1).reshape(
        data.shape)


@register("softmax_cross_entropy", no_grad_inputs=("label",))
def softmax_cross_entropy(data, label):
    """Cross-entropy between softmax(data) and integer labels, summed over
    the batch."""
    logp = log_softmax(data, axis=-1)
    lbl = label.to(torch.int64)
    return -torch.sum(torch.gather(logp, -1, lbl[:, None]))


class _SoftmaxOutput(torch.autograd.Function):
    """softmax forward; backward (softmax - onehot(label)) scaled as the
    reference's loss layer, ignoring the head gradient unless out_grad."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, normalization, smooth_alpha, preserve_shape,
                out_grad):
        if multi_output:
            out = _f32_softmax(data, 1)
        elif preserve_shape or data.dim() <= 2:
            out = _f32_softmax(data, -1)
        else:
            out = _f32_softmax(data.reshape(data.shape[0], -1),
                               -1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, multi_output,
                     normalization, smooth_alpha, preserve_shape, out_grad)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, use_ignore, multi_output, normalization,
         smooth_alpha, preserve_shape, out_grad) = ctx.attrs
        shape = out.shape
        flattened = not multi_output and not preserve_shape and out.dim() > 2
        if flattened:
            out = out.reshape(shape[0], -1)
            g = g.reshape(shape[0], -1)
        axis = 1 if multi_output else -1
        n_class = out.shape[axis]
        lbl = label.to(torch.int64)
        onehot = (lbl.unsqueeze(-1) == torch.arange(
            n_class, device=out.device)).to(out.dtype)
        if multi_output:
            onehot = torch.movedim(onehot, -1, 1)
        if smooth_alpha:
            onehot = onehot * (1 - smooth_alpha) + smooth_alpha / n_class
        grad = out - onehot
        if use_ignore:
            mask = (lbl != int(ignore_label)).to(out.dtype).unsqueeze(axis)
            grad = grad * mask
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            valid = torch.clamp(torch.sum(lbl != int(ignore_label)).to(
                out.dtype), min=1.0)
            grad = grad / valid
        grad = grad * scale
        if out_grad:
            grad = grad * g
        if flattened:
            grad = grad.reshape(shape)
        return (grad, None) + (None,) * 8


@register("SoftmaxOutput", aliases=("Softmax",), no_grad_inputs=("label",))
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   use_ignore=False, multi_output=False,
                   normalization="null", preserve_shape=False,
                   out_grad=False, smooth_alpha=0.0):
    """Softmax forward whose backward is (softmax - one_hot(label)) *
    grad_scale -- the reference's fused softmax loss layer."""
    return _SoftmaxOutput.apply(
        data, label, float(grad_scale), float(ignore_label),
        bool(use_ignore), bool(multi_output), normalization,
        float(smooth_alpha), bool(preserve_shape), bool(out_grad))


def _make_regression_output(name, fwd_fn, grad_fn):
    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = fwd_fn(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, g):
            out, label = ctx.saved_tensors
            return grad_fn(out, label) * ctx.grad_scale, None, None

    @register(name, no_grad_inputs=("label",))
    def op(data, label, *, grad_scale=1.0):
        """Regression output: forward activation with the reference's fixed
        loss gradient, ignoring the head gradient."""
        return _Fn.apply(data, label, float(grad_scale))

    op.__name__ = name
    return op


_make_regression_output(
    "LinearRegressionOutput", lambda x: x,
    lambda o, lb: o - lb.reshape(o.shape))
_make_regression_output(
    "LogisticRegressionOutput", torch.sigmoid,
    lambda o, lb: o - lb.reshape(o.shape))
_make_regression_output(
    "MAERegressionOutput", lambda x: x,
    lambda o, lb: torch.sign(o - lb.reshape(o.shape)))


@register("Dropout", needs_rng=True, needs_training=True)
def dropout(data, *, p=0.5, mode="training", axes=(), cudnn_off=False,
            _rng=None, _training=False):
    """Inverted dropout: keep each element (or each slice along `axes`)
    with probability 1 - p, scaled by 1 / (1 - p)."""
    if not _training and mode != "always":
        return data
    if p <= 0 or _rng is None:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = torch.rand(shape, generator=_rng, device=data.device) < 1.0 - p
    return torch.where(keep, data / (1.0 - p), torch.zeros_like(data))


@register("UpSampling")
def upsampling(*args, scale=2, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest or bilinear (half-pixel) upsampling of NCHW data."""
    data = args[0]
    if sample_type == "nearest":
        return torch.repeat_interleave(
            torch.repeat_interleave(data, scale, dim=2), scale, dim=3)
    return tF.interpolate(data, scale_factor=scale, mode="bilinear",
                          align_corners=False)


@register("im2col")
def im2col(data, *, kernel, stride=(), dilate=(), pad=()):
    """data (N, C, H, W) -> (N, C*prod(kernel), L), channel-major."""
    n_sp = len(kernel)
    return tF.unfold(data, tuple(kernel), dilation=_tup(dilate, n_sp),
                     padding=_tup(pad, n_sp) if pad else 0,
                     stride=_tup(stride, n_sp))


@register("col2im")
def col2im(data, *, output_size, kernel, stride=(), dilate=(), pad=()):
    """The adjoint of im2col: column blocks scatter-added back into an
    (N, C, *output_size) image."""
    n_sp = len(kernel)
    return tF.fold(data, tuple(int(s) for s in output_size), tuple(kernel),
                   dilation=_tup(dilate, n_sp),
                   padding=_tup(pad, n_sp) if pad else 0,
                   stride=_tup(stride, n_sp))


class _SVMOutput(torch.autograd.Function):
    """Identity forward; backward the multiclass hinge-loss gradient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        onehot = (label.to(torch.int64).unsqueeze(-1) == torch.arange(
            out.shape[-1], device=out.device)).to(out.dtype)
        if use_linear:
            g_true = -(margin - out > 0).to(out.dtype)
            g_other = (margin + out > 0).to(out.dtype)
        else:
            g_true = -2.0 * torch.clamp(margin - out, min=0.0)
            g_other = 2.0 * torch.clamp(margin + out, min=0.0)
        return (reg * (onehot * g_true + (1 - onehot) * g_other), None,
                None, None, None)


@register("SVMOutput")
def svm_output(data, label, *, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Identity forward whose backward is the multiclass hinge-loss
    gradient (L1 with use_linear, else L2), ignoring the head gradient."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


# -- the fused RNN (JAX ops/nn.py:711-880) -----------------------------------
# Packed layout: for each layer, for each direction, W_i2h (G*H, in) and
# W_h2h (G*H, H); then for each layer and direction b_i2h (G*H) and b_h2h
# (G*H). Gate orders: LSTM [i, f, g, o], GRU [r, z, n].

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional=False,
                   mode="lstm"):
    """Total packed parameter count of the fused RNN op."""
    G, H, D = _GATES[mode], state_size, 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        inp = input_size if layer == 0 else H * D
        size += D * (G * H * inp + G * H * H)
    return size + num_layers * D * 2 * G * H


def _rnn_slice_params(params, num_layers, input_size, H, D, G):
    """The packed vector as per-(layer, direction) weights and biases."""
    offset = 0

    def take(n, *shape):
        nonlocal offset
        out = params[offset:offset + n].view(*shape)
        offset += n
        return out

    Wx, Wh = [], []
    for layer in range(num_layers):
        inp = input_size if layer == 0 else H * D
        pairs = [(take(G * H * inp, G * H, inp), take(G * H * H, G * H, H))
                 for _ in range(D)]
        Wx.append([p[0] for p in pairs])
        Wh.append([p[1] for p in pairs])
    bx, bh = [], []
    for layer in range(num_layers):
        pairs = [(take(G * H, G * H), take(G * H, G * H)) for _ in range(D)]
        bx.append([p[0] for p in pairs])
        bh.append([p[1] for p in pairs])
    return Wx, Wh, bx, bh


def _rnn_direction(mode, gx, wh, bh, h, c, clip):
    """One layer's scan over time in one direction: `gx` (T, B, G*H) is
    the hoisted input projection x_t W_i2h^T + b_i2h of every step.
    Returns the outputs (T, B, H) and the final h (and c)."""
    ys = []
    wht = wh.t()
    for t in range(gx.shape[0]):
        if mode == "gru":
            gh = torch.addmm(bh, h, wht)
            rx, zx, nx = gx[t].chunk(3, -1)
            rh, zh, nh = gh.chunk(3, -1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
        else:
            gates = torch.addmm(gx[t], h, wht) + bh
            if mode == "lstm":
                i, f, g, o = gates.chunk(4, -1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                if clip is not None:
                    # the cell state is bounded before the output gate
                    # reads it (JAX ops/nn.py:767-770)
                    c = torch.clamp(c, *clip)
                h = torch.sigmoid(o) * torch.tanh(c)
            elif mode == "rnn_tanh":
                h = torch.tanh(gates)
            else:
                h = torch.relu(gates)
        ys.append(h)
    return torch.stack(ys), h, c


def _rnn_outputs(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN", optional=("state_cell",), needs_rng=True,
          needs_training=True, num_outputs=_rnn_outputs)
def rnn(data, parameters, state, state_cell=None, *, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, _rng=None, _training=False):
    """Fused multi-layer (bidirectional) RNN over packed parameters.

    data (T, B, I); state (L*D, B, H), or (L*D, 1, H) broadcast over the
    batch; state_cell (LSTM) likewise. Returns the output (T, B, H*D),
    and with `state_outputs` the final h (and c for LSTM), each
    (L*D, B, H). Dropout `p` applies to the input of every layer after
    the first, in training mode only, drawn from `_rng`."""
    T, B, I = data.shape
    H, D, G = state_size, 2 if bidirectional else 1, _GATES[mode]
    if projection_size:
        raise NotImplementedError(
            "RNN projection_size: use gluon.contrib.rnn.LSTMPCell (the "
            "projected-LSTM path); the fused RNN op runs full-rank cells")
    clip = None
    if mode == "lstm" and (lstm_state_clip_min is not None
                           or lstm_state_clip_max is not None):
        clip = (lstm_state_clip_min, lstm_state_clip_max)
    Wx, Wh, bx, bh = _rnn_slice_params(parameters, num_layers, I, H, D, G)
    x = data
    hs_out, cs_out = [], []
    for layer in range(num_layers):
        if p > 0 and _training and layer > 0 and _rng is not None:
            keep = torch.rand(x.shape, generator=_rng,
                              device=x.device) < 1.0 - p
            x = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
        dir_outs = []
        for d in range(D):
            idx = layer * D + d
            h0 = state[idx].expand(B, H)
            c0 = state_cell[idx].expand(B, H) if mode == "lstm" else None
            xs = torch.flip(x, (0,)) if d == 1 else x
            gx = torch.matmul(xs, Wx[layer][d].t()) + bx[layer][d]
            ys, hN, cN = _rnn_direction(mode, gx, Wh[layer][d],
                                        bh[layer][d], h0, c0, clip)
            dir_outs.append(torch.flip(ys, (0,)) if d == 1 else ys)
            hs_out.append(hN)
            if mode == "lstm":
                cs_out.append(cN)
        x = torch.cat(dir_outs, -1) if D > 1 else dir_outs[0]
    if not state_outputs:
        return x
    if mode == "lstm":
        return x, torch.stack(hs_out), torch.stack(cs_out)
    return x, torch.stack(hs_out)


# -- the CTC loss (JAX ops/nn.py:883-927 over optax.ctc_loss) ----------------

_LOG_EPSILON = -1e5  # optax's log(+0)


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with JAX's forward and derivative: the
    derivative is exp(a - out), as `jnp.logaddexp`'s jvp has it. The
    recursion runs near optax's -1e5 floor for infeasible alignments,
    where float32 rounds `out` to 0.0078; torch's own derivative,
    1 / (1 + exp(b - a)), rounds otherwise, and the gradients would
    part from JAX's by 1e-3 there."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _logaddexp(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return _LogAddExp.apply(a, b)


def _ctc_forward(logits, logit_paddings, labels, label_paddings, blank_id):
    """optax's `ctc_loss_with_forward_probs` loss: per-sequence negative
    log-likelihood of `labels` (B, N) under `logits` (B, T, K)."""
    B, T, K = logits.shape
    N = labels.shape[1]
    eps = _LOG_EPSILON
    logprobs = torch.log_softmax(logits, -1)
    labellens = N - label_paddings.sum(1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = tF.pad(repeat, (0, 1))
    lp_phi = logprobs[:, :, blank_id].t().unsqueeze(-1)      # (T, B, 1)
    # optax's einsum against one_hot(labels): an id outside [0, K) emits 0
    valid = ((labels >= 0) & (labels < K)).to(logits.dtype)
    idx = labels.clamp(0, K - 1).unsqueeze(1).expand(B, T, N)
    lp_emit = (torch.gather(logprobs, 2, idx) * valid.unsqueeze(1))
    lp_emit = lp_emit.transpose(0, 1)                          # (T, B, N)
    pads = logit_paddings.t().unsqueeze(-1).to(logits.dtype)  # (T, B, 1)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], _logaddexp(phi[:, 1:], added)], -1)

    phi = torch.full((B, N + 1), eps, dtype=logits.dtype,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], -1)
    emit = torch.full((B, N), eps, dtype=logits.dtype, device=logits.device)
    for t in range(T):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + eps * repeat)
        next_emit = _logaddexp(prev_phi[:, :-1] + lp_emit[t],
                               emit + lp_emit[t])
        next_phi = update_phi(prev_phi + lp_phi[t],
                              emit + lp_phi[t] + eps * (1.0 - repeat))
        pad = pads[t]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, labellens.unsqueeze(1)).squeeze(1)


@register("CTCLoss", aliases=("ctc_loss",),
          optional=("data_lengths", "label_lengths"),
          no_grad_inputs=("label", "data_lengths", "label_lengths"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None, *,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC loss per sequence. data (T, B, C) unnormalised scores; label
    (B, L) padded with 0 or -1. `blank_label` "first": class 0 is the
    blank and labels are 1-based (0 pads); "last": class C-1 is the
    blank (-1 pads)."""
    T, B, C = data.shape
    dtype = torch.promote_types(data.dtype, torch.float32)
    logits = data.transpose(0, 1).to(dtype)
    if use_data_lengths and data_lengths is not None:
        t = torch.arange(T, device=data.device).unsqueeze(0)
        logit_paddings = t >= data_lengths.to(torch.int64).unsqueeze(1)
    else:
        logit_paddings = torch.zeros((B, T), dtype=torch.bool,
                                     device=data.device)
    lbl = label.to(torch.int64)
    if use_label_lengths and label_lengths is not None:
        pos = torch.arange(label.shape[1], device=data.device).unsqueeze(0)
        label_paddings = pos >= label_lengths.to(torch.int64).unsqueeze(1)
    elif blank_label == "first":
        label_paddings = lbl <= 0
    else:
        label_paddings = lbl < 0
    blank = 0 if blank_label == "first" else C - 1
    return _ctc_forward(logits, logit_paddings, lbl, label_paddings, blank)


alias("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm")
alias("Embedding", "_contrib_SparseEmbedding")
alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
