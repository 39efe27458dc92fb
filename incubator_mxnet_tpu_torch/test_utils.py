"""Numeric testing helpers (`incubator_mxnet_tpu/test_utils.py`): the
default test context, closeness assertions and seeded random arrays.
The symbol-based checks (`simple_forward`, `check_numeric_gradient`,
`check_symbolic_forward` / `_backward`, `check_consistency`) bind
symbols, which wait for the symbolic slice (ROADMAP Queue A 6e): they
raise."""
from __future__ import annotations

import numpy as np

from .context import current_context
from .ndarray.ndarray import NDArray, array as nd_array

__all__ = [
    "default_context", "set_default_context", "assert_almost_equal",
    "almost_equal", "same", "rand_ndarray", "rand_shape_nd",
    "random_arrays", "check_numeric_gradient", "check_symbolic_forward",
    "check_symbolic_backward", "check_consistency", "simple_forward",
    "create_2d_tensor", "rand_coord_2d",
]

_DEFAULT_CTX = [None]


def default_context():
    """The context tests run on: the one `set_default_context` gave, else
    the current context."""
    if _DEFAULT_CTX[0] is not None:
        return _DEFAULT_CTX[0]
    return current_context()


def set_default_context(ctx):
    _DEFAULT_CTX[0] = ctx


def _np(a):
    return a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)


def same(a, b):
    return np.array_equal(a, b)


def almost_equal(a, b, rtol=1e-5, atol=1e-20, equal_nan=False):
    return np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b"),
                        equal_nan=False):
    """Raise with the largest relative error and where it is unless `a`
    and `b` (NDArrays or array-likes) are close."""
    a, b = _np(a), _np(b)
    if not almost_equal(a, b, rtol, atol, equal_nan):
        index = (np.unravel_index(np.argmax(np.abs(a - b)), a.shape)
                 if a.shape else ())
        rel = np.max(np.abs(a - b) / (np.abs(b) + atol + 1e-30))
        raise AssertionError(
            f"Items are not equal (rtol={rtol}, atol={atol}): max rel err "
            f"{rel} at {index}: {names[0]}={a[index] if a.shape else a}, "
            f"{names[1]}={b[index] if b.shape else b}")


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None):
    """Uniform [-1, 1) values of `shape` as an NDArray of storage
    `stype`."""
    arr = np.random.uniform(-1, 1, shape).astype(dtype or np.float32)
    if stype == "default":
        return nd_array(arr, ctx=ctx)
    from .ndarray import sparse

    return sparse.cast_storage(nd_array(arr, ctx=ctx), stype)


def random_arrays(*shapes):
    arrays = [np.random.randn(*s).astype(np.float32) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


def _symbolic(name):
    def check(*args, **kwargs):
        raise NotImplementedError(
            f"test_utils.{name} binds a symbol: the symbolic API waits for "
            "ROADMAP Queue A 6e")

    check.__name__ = name
    return check


simple_forward = _symbolic("simple_forward")
check_numeric_gradient = _symbolic("check_numeric_gradient")
check_symbolic_forward = _symbolic("check_symbolic_forward")
check_symbolic_backward = _symbolic("check_symbolic_backward")
check_consistency = _symbolic("check_consistency")


def create_2d_tensor(rows, columns, dtype=np.int64):
    a = np.arange(0, rows).reshape(rows, 1)
    b = np.broadcast_to(a, shape=(a.shape[0], columns))
    return nd_array(b.astype(dtype))


def rand_coord_2d(x_low, x_high, y_low, y_high):
    x = np.random.randint(x_low, x_high)
    y = np.random.randint(y_low, y_high)
    return x, y
