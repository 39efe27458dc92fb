"""The eager NDArray API (`incubator_mxnet_tpu/ndarray/`): the `NDArray`
class, one generated function per registry op (`nd.relu`,
`nd.FullyConnected`, ...), creation functions, `save` / `load` and the
`random` namespace.

A generated function takes NDArrays (and array-likes) and returns
NDArrays; torch tensors go through the tensor-level namespace
`HybridBlock.hybrid_forward` receives (`register.F`).

`save` / `load` write and read the JAX package's container (magic
`MXTPU001`) byte for byte; reference-format `.params` files are read
through `legacy_io`. Loaded arrays live on `ctx`, by default the
current context, as every array the port makes does. Sparse storage is
the `sparse` namespace (`nd.sparse`, `nd.cast_storage`); `image`,
`linalg` and `contrib` are the registry's families under short names.
DLPack exchange goes through `torch.utils.dlpack` (`from_dlpack`,
`to_dlpack_for_read`, `to_dlpack_for_write`).
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .. import autograd
from ..base import dtype_name, dtype_torch
from ..context import Context, current_context, to_device  # noqa: F401
from .ndarray import NDArray, array, concatenate, waitall  # noqa: F401
from . import register as _register
from .register import F  # noqa: F401

_register.install_ops(globals())

from . import legacy_io  # noqa: E402,F401
from . import random  # noqa: E402,F401
from . import sparse  # noqa: E402,F401
from .sparse import cast_storage  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
from . import image  # noqa: E402,F401
from . import linalg  # noqa: E402,F401


def _default_dtype():
    from .. import config as _config

    return _config.get("MXTPU_DEFAULT_DTYPE")


def _make(fn, shape, ctx, dtype):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray._from_data(fn(shape, dtype=dtype_torch(
        dtype or _default_dtype()), device=to_device(ctx)))


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return _make(torch.zeros, shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return _make(torch.ones, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None, **kwargs):
    return _make(lambda s, **kw: torch.full(s, val, **kw), shape, ctx, dtype)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step,
                       dtype=dtype_torch(dtype or _default_dtype()),
                       device=to_device(ctx))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return NDArray._from_data(out)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    out = _register.invoke_by_name("_eye", (), dict(N=N, M=M, k=k,
                                                    dtype=dtype, ctx=ctx))
    return out


def moveaxis(data, source, destination):
    return data._apply(lambda d: torch.movedim(d, source, destination))


def stack_arrays(*arrays, axis=0):
    return autograd.invoke_recorded(lambda *xs: torch.stack(xs, dim=axis),
                                    list(arrays))[0]


def Custom(*inputs, op_type=None, **kwargs):
    """`nd.Custom(data, ..., op_type='my_op')`: a custom op registered
    with `operator.register`."""
    from ..operator import Custom as _dispatch

    return _dispatch(*inputs, op_type=op_type, **kwargs)


# -- DLPack ------------------------------------------------------------------


def from_dlpack(obj):
    """An NDArray over any DLPack exporter (a torch tensor, a numpy array,
    another framework's tensor) or a legacy 'dltensor' capsule, sharing
    the producer's memory."""
    from torch.utils import dlpack

    return NDArray._from_data(dlpack.from_dlpack(obj))


def to_dlpack_for_read(arr):
    """A legacy DLPack capsule of `arr`'s buffer, on its device, after
    pending work on it has finished."""
    from torch.utils import dlpack

    arr.wait_to_read()
    return dlpack.to_dlpack(arr._data.detach())


def to_dlpack_for_write(arr):
    """A legacy DLPack capsule that aliases `arr`'s buffer: a consumer's
    writes show in `arr` (torch buffers are mutable; the JAX package
    raises here)."""
    from torch.utils import dlpack

    arr.wait_to_read()
    return dlpack.to_dlpack(arr._data.detach())


# -- serialization: the JAX package's container, byte for byte --------------
# magic + count + per entry (name, dtype, shape, raw little-endian bytes)

_MAGIC = b"MXTPU001"


def _entry_bytes(arr):
    """(dtype name, shape, raw bytes) of an array."""
    t = arr._data if isinstance(arr, NDArray) else arr
    if torch.is_tensor(t):
        t = t.detach().cpu().contiguous()
        name = dtype_name(t.dtype)
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy().tobytes()
        return name, tuple(t.shape), raw
    a = np.ascontiguousarray(np.asarray(t))
    return a.dtype.name, a.shape, a.tobytes()


def save(fname, data):
    """Save an NDArray, or a list or dict of them, to a container file."""
    if isinstance(data, NDArray):
        entries = [("", data)]
    elif isinstance(data, (list, tuple)):
        entries = [("", d) for d in data]
    elif isinstance(data, dict):
        entries = sorted(data.items())
    else:
        raise TypeError("save expects NDArray, list, or dict")
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(entries)))
        for name, arr in entries:
            dt, shape, raw = _entry_bytes(arr)
            nb = name.encode("utf-8")
            db = dt.encode("utf-8")
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<i", len(db)))
            f.write(db)
            f.write(struct.pack("<i", len(shape)))
            f.write(struct.pack(f"<{len(shape)}q", *shape))
            f.write(struct.pack("<q", len(raw)))
            f.write(raw)


def _from_raw(raw, dt, shape):
    if dt == "bfloat16":
        return torch.frombuffer(bytearray(raw),
                                dtype=torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dt))
                            .reshape(shape).copy())


def load(fname, ctx=None):
    """Load a container saved by `save` -> list or dict of NDArrays on
    `ctx` (None: the current context); reference-format `.params` files
    are read through `legacy_io`."""
    device = to_device(ctx)
    if legacy_io.is_mxnet_params(fname):
        return legacy_io.load_mxnet_params(fname, ctx=device)
    with open(fname, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{fname}: not a valid NDArray container")
        (count,) = struct.unpack("<q", f.read(8))
        named, anon = {}, []
        for _ in range(count):
            (ln,) = struct.unpack("<i", f.read(4))
            name = f.read(ln).decode()
            (ld,) = struct.unpack("<i", f.read(4))
            dt = f.read(ld).decode()
            (nd_,) = struct.unpack("<i", f.read(4))
            shape = struct.unpack(f"<{nd_}q", f.read(8 * nd_)) if nd_ else ()
            (nb,) = struct.unpack("<q", f.read(8))
            arr = NDArray._from_data(
                _from_raw(f.read(nb), dt, shape).to(device))
            if name:
                named[name] = arr
            else:
                anon.append(arr)
    return named if named else anon
