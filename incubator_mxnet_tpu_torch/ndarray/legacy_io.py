"""Reference-format NDArray container IO (the `.params` files every MXNet
release wrote).

Byte-exact implementation of the reference's serialization
(ref: src/ndarray/ndarray.cc:1776 NDArray::Save(fo, data, names) —
kMXAPINDArrayListMagic header + dmlc vector<NDArray> + vector<string>;
:1576 per-array v2 layout — NDARRAY_V2_MAGIC, storage type, TShape as
uint32 ndim + int64 dims, Context, mshadow type flag, raw buffer; :1662
LegacyLoad for v1/ndim-magic files), so checkpoints trained with the
reference load here offline — the no-egress answer to the reference's
model-zoo downloads (ref: python/mxnet/ndarray/utils.py:222 load).

The port's copy of the JAX package's module. numpy has no bfloat16
here (no `ml_dtypes`), so bfloat16 payloads are read into and written
from torch tensors. Sparse entries load as `RowSparseNDArray` /
`CSRNDArray`; a sparse array saved here is written dense (its
`asnumpy()`), as the JAX package writes it. Loaded arrays live on
`ctx`.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = ["load_mxnet_params", "save_mxnet_params", "is_mxnet_params"]

_LIST_MAGIC = 0x112            # kMXAPINDArrayListMagic
_V2_MAGIC = 0xF993FAC9         # NDARRAY_V2_MAGIC (storage types)
_V1_MAGIC = 0xF993FAC8         # NDARRAY_V1_MAGIC (int64 shapes)

# mshadow type flags (ref: 3rdparty/mshadow/mshadow/base.h kFloat32...)
_TYPE_FLAGS = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
               4: "int32", 5: "int8", 6: "int64", 7: "bool",
               12: "bfloat16"}
_FLAG_OF = {v: k for k, v in _TYPE_FLAGS.items()}

# NDArrayStorageType (ref: include/mxnet/ndarray.h) and its aux counts
_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_NUM_AUX = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt):
        out = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return out if len(out) > 1 else out[0]

    def read_bytes(self, n):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated NDArray container")
        self.pos += n
        return out


def _read_tshape(r, dim_fmt="q"):
    ndim = r.read("I")
    if ndim == 0:
        return ()
    return tuple(r.read(f"{ndim}{dim_fmt}") if ndim > 1
                 else (r.read(dim_fmt),))


def _np_of(r, shape, type_flag):
    dt = _TYPE_FLAGS.get(type_flag)
    if dt is None:
        raise ValueError(f"unknown mshadow type flag {type_flag}")
    n = int(np.prod(shape)) if shape else 1
    if dt == "bfloat16":
        raw = bytearray(r.read_bytes(n * 2))
        return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)
    npdt = np.dtype(dt)
    raw = r.read_bytes(n * np.dtype(npdt).itemsize)
    return np.frombuffer(raw, dtype=npdt).reshape(shape).copy()


def _read_one(r):
    """One NDArray (ref: NDArray::Load ndarray.cc:1693 + LegacyLoad:1662).
    Returns a numpy array, a sparse triple, or None for the empty array."""
    magic = r.read("I")
    if magic == _V2_MAGIC:
        stype = r.read("i")
        nad = _NUM_AUX.get(stype)
        if nad is None:
            raise ValueError(f"unknown storage type {stype}")
        sshape = _read_tshape(r) if nad > 0 else None
        shape = _read_tshape(r)
        if not shape:
            return None
        r.read("ii")  # Context (dev_type, dev_id) — irrelevant on load
        type_flag = r.read("i")
        aux = []
        if nad > 0:
            aux_meta = [(r.read("i"), _read_tshape(r)) for _ in range(nad)]
            data = _np_of(r, sshape, type_flag)
            for aflag, ashape in aux_meta:
                aux.append(_np_of(r, ashape, aflag))
            return ("sparse", stype, shape, data, aux)
        return _np_of(r, shape, type_flag)
    # legacy: V1 (int64 dims) or the magic IS the ndim (uint32 dims)
    if magic == _V1_MAGIC:
        shape = _read_tshape(r, "q")
    else:
        ndim = magic
        if ndim > 32:
            raise ValueError(f"bad NDArray magic 0x{magic:x}")
        shape = tuple(r.read(f"{ndim}I")) if ndim > 1 else \
            ((r.read("I"),) if ndim else ())
    if not shape:
        return None
    r.read("ii")  # Context
    type_flag = r.read("i")
    return _np_of(r, shape, type_flag)


def is_mxnet_params(path_or_bytes):
    """True when the file/bytes carry the reference container magic."""
    if isinstance(path_or_bytes, bytes):
        head = path_or_bytes[:8]
    else:
        with open(path_or_bytes, "rb") as f:
            head = f.read(8)
    return len(head) == 8 and struct.unpack("<Q", head)[0] == _LIST_MAGIC


def load_mxnet_params(path_or_bytes, ctx=None):
    """Read a reference-format .params file -> dict name -> NDArray on
    `ctx` (None: the current context), or a list when the file carries no
    names, exactly like the reference's `mx.nd.load` (ref:
    ndarray.cc:1788 NDArray::Load)."""
    from ..context import to_device
    from .ndarray import NDArray
    from .sparse import CSRNDArray, RowSparseNDArray

    device = to_device(ctx)

    if isinstance(path_or_bytes, bytes):
        buf = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    r = _Reader(buf)
    header, _reserved = r.read("Q"), r.read("Q")
    if header != _LIST_MAGIC:
        raise ValueError("not a reference-format NDArray container "
                         f"(magic 0x{header:x})")
    count = r.read("Q")
    arrays = []
    for _ in range(count):
        item = _read_one(r)
        if item is None:
            arrays.append(None)
        elif isinstance(item, tuple) and item[0] == "sparse":
            _, stype, shape, data, aux = item
            data = NDArray._from_data(torch.as_tensor(data, device=device))
            ids = [NDArray._from_data(torch.as_tensor(
                a.astype(np.int64), device=device)) for a in aux]
            if stype == _STYPE_ROW_SPARSE:
                arrays.append(RowSparseNDArray(data, ids[0], shape))
            else:
                # CSR aux order on disk: kIndPtr=0, kIdx=1
                arrays.append(CSRNDArray(data, ids[0], ids[1], shape))
        else:
            arrays.append(NDArray._from_data(torch.as_tensor(
                item, device=device)))
    n_names = r.read("Q")
    names = []
    for _ in range(n_names):
        ln = r.read("Q")
        names.append(r.read_bytes(ln).decode("utf-8"))
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise ValueError("corrupt container: name/array count mismatch")
    return dict(zip(names, arrays))


def save_mxnet_params(path, data):
    """Write a reference-format .params file the reference itself can load
    (dense arrays; v2 layout). `data`: dict name -> array, or list."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[n] for n in names]
    else:
        names, arrays = [], list(data)
    out = [struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays))]
    for arr in arrays:
        t = arr._data if hasattr(arr, "_data") else arr
        if torch.is_tensor(t) and t.dtype == torch.bfloat16:
            a = t.detach().cpu()
            dt = "bfloat16"
            shape, raw = tuple(a.shape), a.contiguous().view(
                torch.int16).numpy().tobytes()
        else:
            a = np.asarray(arr.asnumpy() if hasattr(arr, "asnumpy")
                           else arr)
            dt = a.dtype.name
            shape, raw = a.shape, np.ascontiguousarray(a).tobytes()
        if dt not in _FLAG_OF:
            raise TypeError(f"dtype {dt} has no mshadow type flag")
        out.append(struct.pack("<Ii", _V2_MAGIC, _STYPE_DEFAULT))
        out.append(struct.pack("<I", len(shape)))
        out.append(struct.pack(f"<{len(shape)}q", *shape))
        out.append(struct.pack("<ii", 1, 0))  # Context: cpu(0)
        out.append(struct.pack("<i", _FLAG_OF[dt]))
        out.append(raw)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        nb = n.encode("utf-8")
        out.append(struct.pack("<Q", len(nb)) + nb)
    blob = b"".join(out)
    if path is None:
        return blob
    with open(path, "wb") as f:
        f.write(blob)
    return path
