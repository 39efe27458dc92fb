"""Tensor math operators (`incubator_mxnet_tpu/ops/tensor.py`): all 178
of its ops under all 254 of its names, each a plain PyTorch expression
with the JAX op's semantics (MXNet axis rules, the reference's float
index outputs, clip / wrap index modes, the Reshape codes). None of them
is a TPU kernel: the JAX package leaves them to XLA, the port to
PyTorch.

Where torch and numpy differ the op follows numpy: `mod` takes the
divisor's sign (`torch.remainder`), a reduction over an empty axis set
is the identity, `topk` breaks ties toward the lower index as
`lax.top_k` does, `sort`/`argsort` descending flip the stable ascending
order, and a negative slice step is taken through an index gather
(torch slicing takes positive steps only).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ..base import dtype_torch
from .registry import alias, register

# ---------------------------------------------------------------------------
# elementwise binary, with broadcasting
# ---------------------------------------------------------------------------


def _binary(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def op(lhs, rhs):
        """Elementwise binary operator with numpy broadcasting; the registered
        name (e.g. broadcast_add) selects the function."""
        return fn(lhs, rhs)

    op.__name__ = name
    return op


def _cmp(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


def _logic(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


_binary("broadcast_add", torch.add, aliases=("elemwise_add", "_plus", "_add"))
_binary("broadcast_sub", torch.sub,
        aliases=("elemwise_sub", "_minus", "_sub"))
_binary("broadcast_mul", torch.mul, aliases=("elemwise_mul", "_mul"))
_binary("broadcast_div", torch.div, aliases=("elemwise_div", "_div"))
_binary("broadcast_mod", torch.remainder, aliases=("_mod",))
_binary("broadcast_power", torch.pow, aliases=("_power", "pow"))
_binary("broadcast_maximum", torch.maximum, aliases=("_maximum", "maximum"))
_binary("broadcast_minimum", torch.minimum, aliases=("_minimum", "minimum"))
_binary("broadcast_hypot", torch.hypot, aliases=("_hypot",))
_binary("broadcast_equal", _cmp(torch.eq), aliases=("_equal",))
_binary("broadcast_not_equal", _cmp(torch.ne), aliases=("_not_equal",))
_binary("broadcast_greater", _cmp(torch.gt), aliases=("_greater",))
_binary("broadcast_greater_equal", _cmp(torch.ge),
        aliases=("_greater_equal",))
_binary("broadcast_lesser", _cmp(torch.lt), aliases=("_lesser",))
_binary("broadcast_lesser_equal", _cmp(torch.le),
        aliases=("_lesser_equal",))
_binary("broadcast_logical_and", _logic(torch.logical_and),
        aliases=("_logical_and",))
_binary("broadcast_logical_or", _logic(torch.logical_or),
        aliases=("_logical_or",))
_binary("broadcast_logical_xor", _logic(torch.logical_xor),
        aliases=("_logical_xor",))


def _scalar_op(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def op(data, *, scalar=1.0):
        """Elementwise op against a static `scalar` attr."""
        return fn(data, scalar)

    op.__name__ = name
    return op


def _full_like(x, s):
    return torch.full((), s, dtype=x.dtype, device=x.device)


_scalar_op("_plus_scalar", lambda x, s: x + s)
_scalar_op("_minus_scalar", lambda x, s: x - s)
_scalar_op("_rminus_scalar", lambda x, s: s - x)
_scalar_op("_mul_scalar", lambda x, s: x * s)
_scalar_op("_div_scalar", lambda x, s: x / s)
_scalar_op("_rdiv_scalar", lambda x, s: s / x)
_scalar_op("_mod_scalar", lambda x, s: torch.remainder(x, s))
_scalar_op("_rmod_scalar", lambda x, s: torch.remainder(_full_like(x, s), x))
_scalar_op("_power_scalar", lambda x, s: torch.pow(x, s))
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar_op("_maximum_scalar", lambda x, s: torch.maximum(x, _full_like(x, s)))
_scalar_op("_minimum_scalar", lambda x, s: torch.minimum(x, _full_like(x, s)))
_scalar_op("_equal_scalar", lambda x, s: (x == s).to(x.dtype))
_scalar_op("_not_equal_scalar", lambda x, s: (x != s).to(x.dtype))
_scalar_op("_greater_scalar", lambda x, s: (x > s).to(x.dtype))
_scalar_op("_greater_equal_scalar", lambda x, s: (x >= s).to(x.dtype))
_scalar_op("_lesser_scalar", lambda x, s: (x < s).to(x.dtype))
_scalar_op("_lesser_equal_scalar", lambda x, s: (x <= s).to(x.dtype))

# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------


def _unary(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def op(data):
        """Elementwise unary function applied to the whole array."""
        return fn(data)

    op.__name__ = name
    return op


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("rint", torch.round)
_unary("round", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", tF.softsign)
_unary("relu", torch.relu)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("reciprocal", torch.reciprocal)
_unary("negative", torch.neg, aliases=("_neg",))
_unary("logical_not", lambda x: torch.logical_not(x).to(x.dtype))
_unary("identity", lambda x: x, aliases=("_copy",))
_unary("BlockGrad", lambda x: x.detach(), aliases=("stop_gradient",))
_unary("make_loss", lambda x: x, aliases=("MakeLoss",))


@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    """Elementwise smooth-L1: quadratic inside |x| < 1/sigma^2, linear
    outside."""
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)


@register("clip")
def clip(data, *, a_min=0.0, a_max=1.0):
    """Clamp values to [a_min, a_max]."""
    return torch.clamp(data, a_min, a_max)


@register("Cast", aliases=("cast",))
def cast(data, *, dtype="float32"):
    """Cast to `dtype`."""
    return data.to(dtype_torch(dtype))


@register("amp_cast")
def amp_cast(data, *, dtype="float32"):
    """AMP dtype cast, the same as `cast`."""
    return data.to(dtype_torch(dtype))


# ---------------------------------------------------------------------------
# reductions: axis int / tuple / None, `exclude` inverts the axis set
# ---------------------------------------------------------------------------


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


_REDUCERS = {
    "sum": lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
    "mean": lambda x, d, k: torch.mean(_float(x), dim=d, keepdim=k),
    "prod": _prod,
    "nansum": lambda x, d, k: torch.nansum(x, dim=d, keepdim=k),
    "nanprod": _nanprod,
    "max": lambda x, d, k: torch.amax(x, dim=d, keepdim=k),
    "min": lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
}


def _reduce(name, aliases=()):
    fn = _REDUCERS[name]

    @register(name, aliases=aliases)
    def op(data, *, axis=None, keepdims=False, exclude=False):
        """Reduction over `axis` (None = all axes) with keepdims/exclude
        semantics."""
        ax = _norm_axis(axis, data.dim(), exclude)
        if not ax:
            return data if name != "mean" else _float(data)
        return fn(data, ax, keepdims)

    op.__name__ = name
    return op


_reduce("sum", aliases=("sum_axis",))
_reduce("mean")
_reduce("prod")
_reduce("nansum")
_reduce("nanprod")
_reduce("max", aliases=("max_axis",))
_reduce("min", aliases=("min_axis",))


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    """Vector norm of order `ord` over `axis`."""
    ax = (tuple(range(data.dim())) if axis is None
          else (axis if isinstance(axis, tuple) else (axis,)))
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
        return out.to(torch.float32)
    return fn(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register("argmax", no_grad_inputs=("data",))
def argmax(data, *, axis=None, keepdims=False):
    """Index of the maximum along `axis`, as float (reference convention)."""
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", no_grad_inputs=("data",))
def argmin(data, *, axis=None, keepdims=False):
    """Index of the minimum along `axis`, as float (reference convention)."""
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", no_grad_inputs=("data",))
def argmax_channel(data):
    """Argmax over axis 1 (the channel dim) for each instance."""
    return torch.argmax(data, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# dot / linalg
# ---------------------------------------------------------------------------


def _mT(x):
    return x.transpose(-1, -2)


@register("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """Dot / matrix product of the two inputs, with optional transposes."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    """Batched matrix product over the leading batch dimension."""
    a = _mT(lhs) if transpose_a else lhs
    b = _mT(rhs) if transpose_b else rhs
    return torch.matmul(a, b)


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def linalg_gemm2(A, B, *, transpose_a=False, transpose_b=False, alpha=1.0):
    """GEMM: alpha * op(A) @ op(B) with optional transposes."""
    a = _mT(A) if transpose_a else A
    b = _mT(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("_linalg_gemm", aliases=("linalg_gemm",))
def linalg_gemm(A, B, C, *, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    """GEMM with accumulate: alpha * op(A) @ op(B) + beta * C."""
    a = _mT(A) if transpose_a else A
    b = _mT(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_potrf", aliases=("linalg_potrf",))
def linalg_potrf(A):
    """Cholesky factor of a symmetric positive-definite matrix."""
    return torch.linalg.cholesky(A)


@register("_linalg_potri", aliases=("linalg_potri",))
def linalg_potri(A):
    """Matrix inverse from a Cholesky factor (potrf output)."""
    ident = torch.eye(A.shape[-1], dtype=A.dtype,
                      device=A.device).expand(A.shape)
    linv = torch.linalg.solve_triangular(A, ident, upper=False)
    return torch.matmul(_mT(linv), linv)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def linalg_trsm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Triangular solve against B (left or right sided), scaled by alpha."""
    a = _mT(A) if transpose else A
    low = bool(lower) != bool(transpose)
    if rightside:
        x = torch.linalg.solve_triangular(_mT(a), _mT(B), upper=low)
        return alpha * _mT(x)
    return alpha * torch.linalg.solve_triangular(a, B, upper=not low)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def linalg_trmm(A, B, *, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """Triangular matrix product: alpha * op(A) @ B (left or right sided)."""
    a = _mT(A) if transpose else A
    a = torch.tril(a) if bool(lower) != bool(transpose) else torch.triu(a)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("_linalg_syrk", aliases=("linalg_syrk",))
def linalg_syrk(A, *, transpose=False, alpha=1.0):
    """Symmetric rank-k update: alpha * A @ A^T (or A^T @ A)."""
    at = _mT(A)
    return alpha * (torch.matmul(at, A) if transpose else torch.matmul(A, at))


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    """Sum of the log of the diagonal entries (log-det from a Cholesky factor)."""
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("_linalg_extractdiag", aliases=("linalg_extractdiag",))
def linalg_extractdiag(A, *, offset=0):
    """Extract the k-th diagonal as a vector."""
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("_linalg_makediag", aliases=("linalg_makediag",))
def linalg_makediag(A, *, offset=0):
    """Embed a vector as the k-th diagonal of a square matrix."""
    return torch.diag_embed(A, offset=offset, dim1=-2, dim2=-1)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


@register("Reshape", aliases=("reshape",))
def reshape(data, *, shape=None, reverse=False):
    """Reshape with the reference's special codes: 0 copy dim, -1 infer, -2
    copy rest, -3 merge two, -4 split."""
    if shape is None:
        return data
    src = list(data.shape)
    out = []
    i = 0
    shape = list(shape)
    if reverse:
        src = src[::-1]
        shape = shape[::-1]
    k = 0
    while k < len(shape):
        s = shape[k]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[k + 1], shape[k + 2]
            k += 2
            a = src[i] // b if a == -1 else a
            b = src[i] // a if b == -1 else b
            out.extend([a, b])
            i += 1
        else:
            out.append(s)
            if i < len(src):
                i += 1
        k += 1
    if reverse:
        out = out[::-1]
    return torch.reshape(data, tuple(out))


@register("reshape_like")
def reshape_like(lhs, rhs):
    """Reshape data to the shape of a second input."""
    return torch.reshape(lhs, rhs.shape)


@register("Flatten", aliases=("flatten",))
def flatten(data):
    """Collapse all dims after the first into one."""
    return data.reshape(data.shape[0], -1)


@register("transpose")
def transpose(data, *, axes=None):
    """Permute axes (reversed order when `axes` is empty)."""
    axes = tuple(axes) if axes else tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("SwapAxis", aliases=("swapaxes",))
def swapaxes(data, *, dim1=0, dim2=0):
    """Exchange two axes."""
    return torch.swapaxes(data, dim1, dim2)


@register("expand_dims")
def expand_dims(data, *, axis=0):
    """Insert a size-1 axis at `axis`."""
    return torch.unsqueeze(data, axis)


@register("squeeze")
def squeeze(data, *, axis=None):
    """Remove size-1 axes (all of them, or just `axis`)."""
    if axis is None:
        return torch.squeeze(data)
    return torch.squeeze(data, axis if isinstance(axis, int) else tuple(axis))


@register("broadcast_to")
def broadcast_to(data, *, shape=None):
    """Broadcast to `shape` (0 keeps the input's dim)."""
    tgt = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    """Broadcast data to the shape of a second input."""
    return torch.broadcast_to(lhs, rhs.shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, *, axis=(), size=()):
    """Broadcast the given size-1 axes to the given sizes."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return torch.broadcast_to(data, tuple(tgt))


@register("zeros_like")
def zeros_like(data):
    """Zeros with the input's shape and dtype."""
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    """Ones with the input's shape and dtype."""
    return torch.ones_like(data)


@register("shape_array", no_grad_inputs=("data",))
def shape_array(data):
    """The input's shape as a 1-D int64 array."""
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@register("size_array", no_grad_inputs=("data",))
def size_array(data):
    """The input's element count as a 1-element int64 array."""
    return torch.tensor([data.numel()], dtype=torch.int64, device=data.device)


def _slice_dim(x, dim, b, e, s):
    """x[..., b:e:s, ...] on `dim`, any step (a negative one through an
    index gather)."""
    if s is None or s > 0:
        return x[(slice(None),) * dim + (slice(b, e, s),)]
    idx = range(*slice(b, e, s).indices(x.shape[dim]))
    return torch.index_select(x, dim, torch.tensor(list(idx),
                                                   dtype=torch.int64,
                                                   device=x.device))


def _take_slices(x, slices):
    for d, sl in enumerate(slices):
        if sl != slice(None):
            x = _slice_dim(x, d, sl.start, sl.stop, sl.step)
    return x


@register("slice")
def slice_op(data, *, begin=(), end=(), step=()):
    """Slice with per-axis begin/end/step (the reference's `slice`)."""
    idx = []
    for i in range(data.dim()):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = (step[i] if i < len(step) and step[i] is not None
             and step[i] != 0 else None)
        idx.append(slice(b, e, s))
    return _take_slices(data, idx)


@register("slice_axis")
def slice_axis(data, *, axis=0, begin=0, end=None):
    """Slice [begin, end) along one axis."""
    return _slice_dim(data, axis % data.dim(), begin, end, None)


@register("slice_like")
def slice_like(data, shape_like, *, axes=()):
    """Slice data down to the shape of a second input on the given axes."""
    axs = (tuple(axes) if axes
           else tuple(range(min(data.dim(), shape_like.dim()))))
    idx = [slice(None)] * data.dim()
    for a in axs:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("Concat", aliases=("concat",))
def concat(*args, dim=1):
    """Concatenate inputs along `dim`."""
    return torch.cat(args, dim=dim)


@register("stack")
def stack(*args, axis=0):
    """Stack inputs along a new `axis`."""
    return torch.stack(args, dim=axis)


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def add_n(*args):
    """Elementwise sum of all inputs."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _split_outputs(attrs):
    return int(attrs.get("num_outputs", 1))


@register("SliceChannel", aliases=("split",), num_outputs=_split_outputs)
def split(data, *, num_outputs=1, axis=1, squeeze_axis=False):
    """Split into `num_outputs` parts along `axis` (multi-output)."""
    if data.shape[axis] % num_outputs:
        raise ValueError("array split does not result in an equal division")
    parts = torch.split(data, data.shape[axis] // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("tile")
def tile(data, *, reps=()):
    """Repeat the whole array `reps` times per axis."""
    return torch.tile(data, tuple(reps) if not isinstance(reps, int)
                      else (reps,))


@register("repeat")
def repeat(data, *, repeats=1, axis=None):
    """Repeat each element `repeats` times along `axis`."""
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("reverse", aliases=("flip",))
def reverse(data, *, axis=()):
    """Reverse along the given axes."""
    axs = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, dims=axs)


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@register("Pad", aliases=("pad",))
def pad(data, *, mode="constant", pad_width=(), constant_value=0.0):
    """Pad spatial dims of 4-D/5-D input with constant/edge/reflect padding."""
    pw = [(pad_width[2 * i], pad_width[2 * i + 1])
          for i in range(len(pad_width) // 2)]
    pw += [(0, 0)] * (data.dim() - len(pw))
    if mode == "constant":
        flat = [v for pair in reversed(pw) for v in pair]
        return tF.pad(data, flat, value=constant_value)
    if mode not in _PAD_MODES:
        raise ValueError(f"unknown pad mode {mode}")
    if any(pw[0]) or any(pw[1]):
        raise ValueError(f"pad mode {mode!r} pads the spatial dims only")
    flat = [v for pair in reversed(pw[2:]) for v in pair]
    return tF.pad(data, flat, mode=_PAD_MODES[mode])


@register("diag")
def diag(data, *, k=0):
    """Extract the k-th diagonal (>=2-D input) or build a diagonal matrix
    (1-D)."""
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("depth_to_space")
def depth_to_space(data, *, block_size=2):
    """Rearrange channel blocks into spatial blocks (NCHW, block_size)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, *, block_size=2):
    """Rearrange spatial blocks into channels (NCHW, block_size)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------


def _index(idx, n, mode="clip"):
    idx = idx.to(torch.int64)
    if mode == "wrap":
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)


@register("take", no_grad_inputs=("indices",))
def take(a, indices, *, axis=0, mode="clip"):
    """Gather slices along `axis` by integer indices, with clip/wrap modes."""
    ax = axis % a.dim()
    idx = _index(indices, a.shape[ax], mode)
    out = torch.index_select(a, ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("batch_take", no_grad_inputs=("indices",))
def batch_take(a, indices):
    """Per-row gather: out[i] = data[i, indices[i]]."""
    idx = _index(indices, a.shape[1])
    return a[torch.arange(a.shape[0], device=a.device), idx]


@register("pick", no_grad_inputs=("index",))
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """Pick one element per row along `axis` by index."""
    ax = axis % data.dim()
    idx = _index(index, data.shape[ax], mode)
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


@register("Embedding", no_grad_inputs=("data",))
def embedding(data, weight, *, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Look up integer indices in a (input_dim, output_dim) weight table."""
    return tF.embedding(_index(data, weight.shape[0]), weight)


@register("gather_nd", no_grad_inputs=("indices",))
def gather_nd(data, indices):
    """Gather elements addressed by the leading index dimension."""
    idx = indices.to(torch.int64)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", no_grad_inputs=("indices",))
def scatter_nd(data, indices, *, shape=None):
    """Scatter data into zeros of `shape` at the given indices."""
    idx = indices.to(torch.int64)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


@register("one_hot", no_grad_inputs=("indices",))
def one_hot(indices, *, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """One-hot encode integer indices to `depth` classes with on/off values."""
    idx = indices.to(torch.int64)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device)).to(
        torch.float32)
    return (oh * (on_value - off_value) + off_value).to(dtype_torch(dtype))


@register("where", no_grad_inputs=("condition",))
def where(condition, x, y):
    """Select elementwise from x or y by condition."""
    return torch.where(condition.to(torch.bool), x, y)


@register("boolean_mask", no_grad_inputs=("index",))
def boolean_mask(data, index, *, axis=0):
    """Keep rows where the boolean mask is set (a data-dependent shape: the
    mask is read on the host)."""
    keep = torch.nonzero(index.to(torch.bool).reshape(-1)).reshape(-1)
    return torch.index_select(data, axis, keep)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


@register("sort")
def sort(data, *, axis=-1, is_ascend=True):
    """Sort along `axis`, optionally descending."""
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort", no_grad_inputs=("data",))
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    """Indices that would sort along `axis`, cast to the requested dtype."""
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(dtype_torch(dtype))


def _topk_outputs(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", no_grad_inputs=("data",), num_outputs=_topk_outputs)
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """Top-k values/indices along `axis` with the reference's ret_typ modes
    (ties: the lower index first, as `lax.top_k`)."""
    ax = axis % data.dim()
    src = -data if is_ascend else data
    order = torch.sort(src, dim=ax, descending=True, stable=True)
    idxs = order.indices.narrow(ax, 0, k)
    vals = torch.gather(data, ax, idxs)
    idxs = idxs.to(dtype_torch(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxs
    return idxs


# ---------------------------------------------------------------------------
# sequence ops
# ---------------------------------------------------------------------------


@register("SequenceMask", optional=("sequence_length",),
          no_grad_inputs=("sequence_length",))
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    """Mask time steps beyond each sequence's length with `value` (TNC layout)."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :].to(torch.int64)
    if axis == 1:
        mask = mask.t()
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    shape[1 - axis] = data.shape[1 - axis]
    mask = mask.reshape(shape)
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast", optional=("sequence_length",),
          no_grad_inputs=("sequence_length",))
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    """Last valid time step of each sequence (TNC layout)."""
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, data.shape[axis] - 1)
    last = sequence_length.to(torch.int64) - 1
    moved = torch.movedim(data, axis, 0)
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse", optional=("sequence_length",),
          no_grad_inputs=("sequence_length",))
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                     axis=0):
    """Reverse each sequence up to its length (TNC layout)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = torch.movedim(data, axis, 0)
    T = moved.shape[0]
    lens = sequence_length.to(torch.int64)
    t = torch.arange(T, device=data.device)[:, None]
    src = torch.where(t < lens[None, :], lens[None, :] - 1 - t, t)
    src = src.reshape(src.shape + (1,) * (moved.dim() - 2)).expand(
        moved.shape)
    return torch.movedim(torch.gather(moved, 0, src), 0, axis)


# ---------------------------------------------------------------------------
# init-like ops
# ---------------------------------------------------------------------------


@register("_arange_like", no_grad_inputs=("data",))
def arange_like(data, *, start=0.0, step=1.0, axis=None):
    """arange shaped like the input along `axis` (or its flattened size)."""
    n = data.numel() if axis is None else data.shape[axis]
    return start + step * torch.arange(n, dtype=torch.float32,
                                       device=data.device)


@register("histogram", no_grad_inputs=("data",))
def histogram(data, *, bin_cnt=10, range=None):
    """Histogram counts of the input."""
    lo, hi = (range if range is not None
              else (float(data.min()), float(data.max())))
    return torch.histc(data.to(torch.float32), bins=bin_cnt, min=lo, max=hi)


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    """clip(alpha * x + beta, 0, 1)."""
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("khatri_rao")
def khatri_rao(*args):
    """Column-wise Kronecker product: (n_i, k) inputs -> (prod n_i, k)."""
    out = args[0]
    for m in args[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("_ravel_multi_index", aliases=("ravel_multi_index",),
          no_grad_inputs=("data",))
def ravel_multi_index(data, *, shape):
    """(ndim, N) coordinates -> (N,) flat indices for `shape` (int32 index
    math, as the JAX op: index spaces beyond 2^31-1 are rejected)."""
    strides = []
    acc = 1
    for dim in tuple(shape)[::-1]:
        strides.append(acc)
        acc *= int(dim)
    if acc >= 2 ** 31:
        raise ValueError(
            f"shape {tuple(shape)} has {acc} elements; int32 flat indexing "
            "overflows beyond 2**31-1")
    strides = torch.tensor(strides[::-1], dtype=torch.int32,
                           device=data.device)
    return torch.sum(data.to(torch.int32) * strides[:, None], dim=0,
                     dtype=torch.int32)


@register("_unravel_index", aliases=("unravel_index",),
          no_grad_inputs=("data",))
def unravel_index(data, *, shape):
    """(N,) flat indices -> (ndim, N) coordinates."""
    if math.prod(int(d) for d in shape) >= 2 ** 31:
        raise ValueError(
            f"shape {tuple(shape)} exceeds int32 flat-index range")
    coords = torch.unravel_index(data.to(torch.int64),
                                 tuple(int(d) for d in shape))
    return torch.stack(coords, dim=0).to(torch.int32)


@register("_square_sum", aliases=("square_sum",))
def square_sum(data, *, axis=None, keepdims=False):
    """sum(x^2) in one pass."""
    ax = (tuple(range(data.dim())) if axis is None
          else tuple(axis) if isinstance(axis, (list, tuple)) else axis)
    return torch.sum(torch.square(data), dim=ax, keepdim=keepdims)


def _split_v2_outputs(attrs):
    ios = attrs.get("indices_or_sections", 1)
    if isinstance(ios, (list, tuple)):
        return len(ios) + 1
    return int(ios)


@register("_split_v2", aliases=("split_v2",), num_outputs=_split_v2_outputs)
def split_v2(data, *, indices_or_sections=1, axis=0, squeeze_axis=False):
    """Split by section count or explicit indices."""
    ios = indices_or_sections
    if isinstance(ios, (list, tuple)):
        parts = torch.tensor_split(data, list(ios), dim=axis)
    else:
        if data.shape[axis] % int(ios):
            raise ValueError("array split does not result in an equal "
                             "division")
        parts = torch.tensor_split(data, int(ios), dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def linalg_gelqf(A):
    """LQ factorization A = L @ Q with Q orthonormal rows, as the transpose
    of the QR factorization of A^T."""
    q, r = torch.linalg.qr(_mT(A), mode="reduced")
    return _mT(r), _mT(q)


@register("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def linalg_syevd(A):
    """Symmetric eigendecomposition: (U, L) with A = U^T diag(L) U (the
    eigenvectors as rows)."""
    w, v = torch.linalg.eigh(A)
    return _mT(v), w


_unary("digamma", torch.digamma)


@register("polygamma")
def polygamma(data, *, n=0):
    """n-th derivative of digamma."""
    return torch.polygamma(int(n), data)


_scalar_op("_hypot_scalar", lambda x, s: torch.hypot(x, _full_like(x, s)))
_scalar_op("_logical_and_scalar",
           lambda x, s: ((x != 0) & (s != 0)).to(x.dtype))
_scalar_op("_logical_or_scalar",
           lambda x, s: ((x != 0) | (s != 0)).to(x.dtype))
_scalar_op("_logical_xor_scalar",
           lambda x, s: ((x != 0) ^ (s != 0)).to(x.dtype))

alias("_plus_scalar", "_scatter_plus_scalar")
alias("_minus_scalar", "_scatter_minus_scalar")
alias("broadcast_div", "_scatter_elemwise_div")
alias("broadcast_add", "_grad_add")
alias("histogram", "_histogram")
alias("boolean_mask", "_contrib_boolean_mask")
alias("broadcast_add", "broadcast_plus")
alias("broadcast_sub", "broadcast_minus")
alias("pick", "choose_element_0index")
alias("slice", "crop")


@register("_arange", aliases=("arange",))
def _arange(*, start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32"):
    """arange(start, stop, step), each value `repeat` times."""
    if stop is None:
        start, stop = 0.0, start
    vals = torch.arange(start, stop, step, dtype=dtype_torch(dtype))
    if repeat > 1:
        vals = torch.repeat_interleave(vals, repeat)
    return vals


@register("_eye", aliases=("eye",))
def _eye(*, N, M=0, k=0, dtype="float32"):
    """An N x M matrix with ones on the k-th diagonal."""
    n, m = int(N), int(M) or int(N)
    rows = torch.arange(n)[:, None]
    cols = torch.arange(m)[None, :]
    return (cols - rows == int(k)).to(dtype_torch(dtype))


@register("_full", aliases=("full",))
def _full(*, shape, value, dtype="float32"):
    """An array of `shape` filled with `value`."""
    return torch.full(tuple(shape), value, dtype=dtype_torch(dtype))


@register("_zeros", aliases=("_zeros_without_dtype",))
def _zeros(*, shape, dtype="float32"):
    """Zeros of `shape`."""
    return torch.zeros(tuple(shape), dtype=dtype_torch(dtype))


@register("_ones")
def _ones(*, shape, dtype="float32"):
    """Ones of `shape`."""
    return torch.ones(tuple(shape), dtype=dtype_torch(dtype))


def _slice_index(begin, end, step):
    out = []
    for i, (b, e) in enumerate(zip(begin, end)):
        s = step[i] if i < len(step) else None
        out.append(slice(None if b is None else int(b),
                         None if e is None else int(e),
                         None if not s else int(s)))
    return tuple(out)


@register("_slice_assign")
def _slice_assign(lhs, rhs, *, begin, end, step=()):
    """lhs with lhs[begin:end:step] replaced by rhs (a new array)."""
    out = lhs.clone()
    out[_slice_index(begin, end, step)] = rhs
    return out


@register("_slice_assign_scalar")
def _slice_assign_scalar(data, *, scalar, begin, end, step=()):
    """data with data[begin:end:step] set to `scalar` (a new array)."""
    out = data.clone()
    out[_slice_index(begin, end, step)] = scalar
    return out


@register("_scatter_set_nd", no_grad_inputs=("indices",))
def _scatter_set_nd(lhs, rhs, indices, *, shape=None):
    """lhs with rhs written at gather_nd-style indices (a new array)."""
    idx = indices.to(torch.int64)
    out = lhs.clone()
    out[tuple(idx[i] for i in range(idx.shape[0]))] = rhs
    return out


@register("_identity_with_attr_like_rhs", no_grad_inputs=("rhs",))
def _identity_with_attr_like_rhs(lhs, rhs):
    """Identity of lhs."""
    return lhs


@register("_contrib_bipartite_matching", num_outputs=2,
          no_grad_inputs=("data",))
def _contrib_bipartite_matching(data, *, threshold=None, is_ascend=False,
                                topk=-1):
    """Greedy bipartite matching over a (rows, cols) score matrix, or a
    batch of them: repeatedly take the best remaining pair that passes
    `threshold`; returns (row->col, col->row) assignments, -1 unmatched."""
    if data.dim() > 2:
        lead = data.shape[:-2]
        flat = data.reshape((-1,) + tuple(data.shape[-2:]))
        outs = [_contrib_bipartite_matching(m, threshold=threshold,
                                            is_ascend=is_ascend, topk=topk)
                for m in flat]
        return (torch.stack([o[0] for o in outs]).reshape(
                    lead + (data.shape[-2],)),
                torch.stack([o[1] for o in outs]).reshape(
                    lead + (data.shape[-1],)))
    n, m = data.shape
    steps = min(n, m) if topk < 0 else min(topk, min(n, m))
    if threshold is None:
        thr = -math.inf
    else:
        thr = -float(threshold) if is_ascend else float(threshold)
    sign = -1.0 if is_ascend else 1.0
    scores = sign * data.to(torch.float32)
    row_match = torch.full((n,), -1.0, device=data.device)
    col_match = torch.full((m,), -1.0, device=data.device)
    for _ in range(steps):
        flat = int(torch.argmax(scores))
        r, c = flat // m, flat % m
        if float(scores[r, c]) > thr:
            row_match[r] = c
            col_match[c] = r
            scores[r, :] = -math.inf
            scores[:, c] = -math.inf
        else:
            scores[r, c] = -math.inf
    return row_match, col_match
