"""Sparse storage and its operators (`incubator_mxnet_tpu/ndarray/sparse.py`).

`RowSparseNDArray` holds the rows at `indices` (`data`, one row each);
every other row is zero. `CSRNDArray` is a compressed sparse row matrix
(`data`, `indptr`, `indices`). Both keep their parts as NDArrays on one
device, with int64 index tensors (the JAX package's are int32 on the
CPU, where x64 is off: compare values, not dtypes).

The arithmetic is gathers, dense products of the gathered block and
segment sums, as in the JAX package. A segment sum adds duplicate
targets with `index_put_(accumulate=True)`, which sorts the targets on
the card and so sums them in the same order on every run (an
`index_add_` there adds with atomics, in an order that changes from run
to run). Index-set algebra (unions, `retain`'s mask, the rows a
`csr^T . dense` touches) is data-dependent and runs on the host.

`bucket_nnz` / `pad_row_ids` are the nnz grid every consumer shares
under `MXTPU_SPARSE_NNZ_BUCKETING` (the embedding service's pull blocks,
the kvstore's row pulls): the smallest power of two at or above n, at
least 16.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import dtype_torch
from ..context import to_device
from .ndarray import NDArray

__all__ = [
    "BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
    "row_sparse_array", "csr_matrix", "cast_storage", "zeros", "retain",
    "dot", "add", "subtract", "multiply", "add_n", "bucket_nnz",
    "pad_row_ids",
]


def _as_nd(x, device=None, dtype=None):
    """An NDArray over `x` on `device` (None: an NDArray or tensor keeps
    its own, numpy and lists land on the current context)."""
    if isinstance(x, NDArray):
        t = x._data
        if dtype is not None:
            t = t.to(dtype)
        if device is not None:
            t = t.to(device)
        return NDArray._from_data(t)
    if torch.is_tensor(x):
        t = x.detach()
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    if dtype is not None:
        t = t.to(dtype)
    dev = device if device is not None else (
        t.device if torch.is_tensor(x) else to_device(None))
    return NDArray._from_data(t.to(dev))


def _idx(x, device=None):
    return _as_nd(x, device, torch.int64)


def _host(t):
    return t._data.detach().cpu().numpy() if isinstance(t, NDArray) \
        else np.asarray(t)


class BaseSparseNDArray:
    @property
    def context(self):
        return self.data.context

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data._data.device

    def wait_to_read(self):
        self.data.wait_to_read()

    def __add__(self, other):
        return add(self, other)

    def __sub__(self, other):
        return subtract(self, other)

    def __mul__(self, other):
        return multiply(self, other)

    __radd__ = __add__
    __rmul__ = __mul__


class RowSparseNDArray(BaseSparseNDArray):
    """Rows at `indices` hold `data`; the other rows are zero. `unique`
    says the producer knows the indices hold no repeat, so a lazy update
    need not fold duplicates."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape, unique=False):
        self.data = _as_nd(data)
        self.indices = _idx(indices, self.data._data.device)
        self.shape = tuple(int(s) for s in shape)
        self.unique = bool(unique)

    @property
    def nnz(self):
        return int(self.indices.shape[0])

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError(stype)

    def todense(self) -> NDArray:
        d = self.data._data
        out = torch.zeros(self.shape, dtype=d.dtype, device=d.device)
        out[self.indices._data] = d.detach()
        return NDArray._from_data(out)

    def asnumpy(self):
        return self.todense().asnumpy()

    def copyto(self, other):
        return self.todense().copyto(other)

    def copy(self):
        return RowSparseNDArray(NDArray._from_data(self.data._data.clone()),
                                NDArray._from_data(self.indices._data.clone()),
                                self.shape, self.unique)

    def check_format(self, full_check=True):
        """Indices strictly ascending, in range, one per data row."""
        idx = _host(self.indices)
        if idx.shape[0] != self.data.shape[0]:
            raise ValueError("indices/data length mismatch")
        if idx.size and np.any(np.diff(idx) <= 0):
            raise ValueError("row_sparse indices must be strictly ascending")
        if idx.size and (idx[0] < 0 or idx[-1] >= self.shape[0]):
            raise ValueError("row index out of range")

    def retain(self, indices):
        return retain(self, indices)

    def __repr__(self):
        return (f"<RowSparseNDArray {'x'.join(map(str, self.shape))} "
                f"nnz_rows={self.indices.shape[0]}>")


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix."""

    stype = "csr"

    def __init__(self, data, indptr, indices, shape):
        self.data = _as_nd(data)
        dev = self.data._data.device
        self.indptr = _idx(indptr, dev)
        self.indices = _idx(indices, dev)
        self.shape = tuple(int(s) for s in shape)

    @property
    def nnz(self):
        return int(self.data.shape[0])

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        if stype == "row_sparse":
            return row_sparse_array(self.todense())
        raise ValueError(stype)

    def todense(self) -> NDArray:
        d = self.data._data
        rows = _row_ids(self.indptr._data, d.shape[0])
        out = torch.zeros(self.shape, dtype=d.dtype, device=d.device)
        out.index_put_((rows, self.indices._data), d.detach(),
                       accumulate=True)
        return NDArray._from_data(out)

    def asnumpy(self):
        return self.todense().asnumpy()

    def copy(self):
        return CSRNDArray(NDArray._from_data(self.data._data.clone()),
                          NDArray._from_data(self.indptr._data.clone()),
                          NDArray._from_data(self.indices._data.clone()),
                          self.shape)

    def check_format(self, full_check=True):
        indptr = _host(self.indptr)
        idx = _host(self.indices)
        if indptr.shape[0] != self.shape[0] + 1:
            raise ValueError("indptr length must be rows+1")
        if indptr[0] != 0 or indptr[-1] != idx.shape[0]:
            raise ValueError("indptr endpoints invalid")
        if np.any(np.diff(indptr) < 0):
            raise ValueError("indptr must be non-decreasing")
        if idx.size and (idx.min() < 0 or idx.max() >= self.shape[1]):
            raise ValueError("column index out of range")

    def __getitem__(self, key):
        """Row slicing with step 1 (an int is a one-row slice); returns a
        CSRNDArray."""
        if isinstance(key, int):
            if key < 0:
                key += self.shape[0]
            if not 0 <= key < self.shape[0]:
                raise IndexError(f"row {key} out of range")
            key = slice(key, key + 1)
        if not isinstance(key, slice):
            raise TypeError("CSR supports int/slice row indexing")
        start, stop, stride = key.indices(self.shape[0])
        if stride != 1:
            raise ValueError("CSR slicing requires step 1")
        stop = max(stop, start)
        indptr = _host(self.indptr)
        lo, hi = int(indptr[start]), int(indptr[stop])
        dev = self.device
        return CSRNDArray(
            NDArray._from_data(self.data._data[lo:hi].clone()),
            _idx(indptr[start:stop + 1] - lo, dev),
            NDArray._from_data(self.indices._data[lo:hi].clone()),
            (stop - start, self.shape[1]))

    def __repr__(self):
        return (f"<CSRNDArray {'x'.join(map(str, self.shape))} "
                f"nnz={self.data.shape[0]}>")


# -- the kernels: gathers, products and segment sums ----------------------------

def _row_ids(indptr, nnz):
    """The row of each nonzero: searchsorted over indptr (a padded entry
    past indptr[-1] gets row m)."""
    ar = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr, ar, right=True) - 1


def _segment_sum(values, segments, num_segments):
    """Rows of `values` summed by `segments` into `num_segments` rows; a
    segment id at or past num_segments is dropped. Deterministic on the
    card (sorted accumulation)."""
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    seg = torch.clamp(segments, max=num_segments)
    out.index_put_((seg,), values, accumulate=True)
    return out[:num_segments]


def _csr_dot_dense(data, indices, indptr, rhs, m):
    """csr(m, k) . dense(k, n) -> dense(m, n). nnz padding (data 0, row
    id m) contributes nothing."""
    rows = _row_ids(indptr, data.shape[0])
    gathered = rhs[indices]
    prod = data.reshape(-1, *([1] * (rhs.dim() - 1))) * gathered
    return _segment_sum(prod, rows, m)


def _csr_T_dot_dense(data, indices, indptr, rhs, k):
    """csr(m, k)^T . dense(m, n) -> dense(k, n)."""
    rows = _row_ids(indptr, data.shape[0])
    gathered = rhs[torch.clamp(rows, 0, rhs.shape[0] - 1)]
    prod = data.reshape(-1, *([1] * (rhs.dim() - 1))) * gathered
    return _segment_sum(prod, indices, k)


# -- the nnz grid ---------------------------------------------------------------

def _bucket_nnz(n):
    n = int(n)
    if n <= 16:
        return 16
    return 1 << (n - 1).bit_length()


def _pad_nnz(data, indices):
    """(data, indices) padded along nnz to the bucket with zeros under
    MXTPU_SPARSE_NNZ_BUCKETING, else unchanged."""
    from .. import config as _config

    if not _config.get("MXTPU_SPARSE_NNZ_BUCKETING"):
        return data, indices
    n = int(data.shape[0])
    b = _bucket_nnz(n)
    if b == n:
        return data, indices
    pad = b - n
    data = torch.cat([data, data.new_zeros((pad,) + tuple(data.shape[1:]))])
    indices = torch.cat([indices, indices.new_zeros((pad,))])
    return data, indices


def bucket_nnz(n):
    """The nnz a sparse buffer is padded to under
    MXTPU_SPARSE_NNZ_BUCKETING: the smallest power of two >= n, at
    least 16."""
    return _bucket_nnz(n)


def pad_row_ids(ids, force=False):
    """A host row-id vector padded to its nnz bucket by repeating the last
    id (a padded pull fetches a row it fetches anyway); returns
    (padded_ids, n_valid). Only the int64 cast while bucketing is off and
    `force` is not set."""
    from .. import config as _config

    ids = np.asarray(ids, np.int64).reshape(-1)
    n = int(ids.shape[0])
    if not (force or _config.get("MXTPU_SPARSE_NNZ_BUCKETING")):
        return ids, n
    b = _bucket_nnz(n)
    if b == n or n == 0:
        return ids, n
    return np.concatenate([ids, np.full(b - n, ids[-1], np.int64)]), n


def dot(lhs, rhs, transpose_a=False):
    """dot(csr, dense) -> dense; dot(csr, dense, transpose_a=True) ->
    row_sparse over the columns any nonzero touches; dot(dense, rsp) ->
    dense; a row_sparse lhs is densified."""
    if isinstance(lhs, CSRNDArray):
        r = rhs._data if isinstance(rhs, NDArray) else rhs.todense()._data
        if not transpose_a:
            return NDArray._from_data(_csr_dot_dense(
                lhs.data._data, lhs.indices._data, lhs.indptr._data, r,
                lhs.shape[0]))
        dense_out = _csr_T_dot_dense(lhs.data._data, lhs.indices._data,
                                     lhs.indptr._data, r, lhs.shape[1])
        cols = np.unique(_host(lhs.indices).astype(np.int64))
        cols_t = torch.from_numpy(cols).to(dense_out.device)
        return RowSparseNDArray(
            NDArray._from_data(dense_out[cols_t]),
            NDArray._from_data(cols_t),
            (lhs.shape[1],) + tuple(dense_out.shape[1:]), unique=True)
    if isinstance(lhs, NDArray) and isinstance(rhs, RowSparseNDArray):
        if transpose_a:
            raise NotImplementedError("dot(dense^T, rsp) unsupported")
        cols = lhs._data[:, rhs.indices._data]
        return NDArray._from_data(cols @ rhs.data._data)
    if isinstance(lhs, RowSparseNDArray):
        ld = lhs.todense()._data
        r = rhs._data if isinstance(rhs, NDArray) else rhs.todense()._data
        return NDArray._from_data((ld.T if transpose_a else ld) @ r)
    raise TypeError(f"unsupported sparse dot: {type(lhs)} x {type(rhs)}")


# -- elementwise: the index union on the host, the values on the device --------

def _rsp_binary(lhs, rhs, fn):
    assert lhs.shape == rhs.shape, (lhs.shape, rhs.shape)
    li, ri = _host(lhs.indices), _host(rhs.indices)
    union = np.union1d(li, ri).astype(np.int64)
    ld, rd = lhs.data._data, rhs.data._data
    dev = ld.device
    width = tuple(ld.shape[1:])
    lfull = torch.zeros((len(union),) + width, dtype=ld.dtype, device=dev)
    rfull = torch.zeros((len(union),) + width, dtype=rd.dtype, device=dev)
    if li.size:
        lfull[torch.from_numpy(np.searchsorted(union, li)).to(dev)] = ld
    if ri.size:
        rfull[torch.from_numpy(np.searchsorted(union, ri)).to(dev)] = \
            rd.to(dev)
    return RowSparseNDArray(NDArray._from_data(fn(lfull, rfull)),
                            NDArray._from_data(torch.from_numpy(union)
                                               .to(dev)), lhs.shape,
                            unique=True)


def _dense_fallback(lhs, rhs, fn):
    ld = _dense_tensor(lhs)
    rd = _dense_tensor(rhs, like=ld)
    return NDArray._from_data(fn(ld, rd))


def _dense_tensor(x, like=None):
    if isinstance(x, BaseSparseNDArray):
        return x.todense()._data
    if isinstance(x, NDArray):
        return x._data
    return torch.as_tensor(np.asarray(x), device=None if like is None
                           else like.device)


def add(lhs, rhs):
    """Elementwise sum; rsp + rsp stays row_sparse."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return _rsp_binary(lhs, rhs, torch.add)
    return _dense_fallback(lhs, rhs, torch.add)


def subtract(lhs, rhs):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return _rsp_binary(lhs, rhs, torch.sub)
    return _dense_fallback(lhs, rhs, torch.sub)


def multiply(lhs, rhs):
    if isinstance(lhs, BaseSparseNDArray) and np.isscalar(rhs):
        out = lhs.copy()
        out.data._data = out.data._data * rhs
        return out
    if isinstance(rhs, BaseSparseNDArray) and np.isscalar(lhs):
        return multiply(rhs, lhs)
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return _rsp_binary(lhs, rhs, torch.mul)
    return _dense_fallback(lhs, rhs, torch.mul)


def add_n(*arrs):
    """The sum of sparse and dense arrays."""
    acc = arrs[0]
    for a in arrs[1:]:
        acc = add(acc, a)
    return acc


# -- constructors and conversion ------------------------------------------------

def row_sparse_array(arg, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (data, indices) and a shape, or from a dense
    array (its nonzero rows), on `ctx` (None: the current context; an
    NDArray argument keeps its device)."""
    dev = to_device(ctx) if ctx is not None else None
    if isinstance(arg, tuple) and len(arg) == 2:
        data, indices = arg
        if not isinstance(data, NDArray):
            data = np.asarray(data, dtype=np.float32 if dtype is None
                              else dtype)
        data = _as_nd(data, dev)
        return RowSparseNDArray(data, _idx(indices, data._data.device),
                                shape)
    if isinstance(arg, NDArray):
        d = arg._data.detach()
        dev = dev or d.device
        dense = d.to(dev)
    else:
        dense = torch.from_numpy(np.ascontiguousarray(np.asarray(arg)))
        dense = dense.to(dev or to_device(None))
    nz = dense.reshape(dense.shape[0], -1).ne(0).any(dim=1) \
        if dense.dim() > 1 else dense.ne(0)
    rows = torch.nonzero(nz).reshape(-1)
    return RowSparseNDArray(NDArray._from_data(dense[rows]),
                            NDArray._from_data(rows), tuple(dense.shape),
                            unique=True)


def csr_matrix(arg, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr) and a shape, or from a
    2-D dense array."""
    dev = to_device(ctx) if ctx is not None else None
    if isinstance(arg, tuple) and len(arg) == 3:
        data, indices, indptr = arg
        data = _as_nd(data if isinstance(data, NDArray) else np.asarray(data),
                      dev)
        d = data._data.device
        return CSRNDArray(data, _idx(indptr, d), _idx(indices, d), shape)
    if isinstance(arg, NDArray):
        dev = dev or arg._data.device
        dense = arg.asnumpy()
    else:
        dense = np.asarray(arg)
    if dense.ndim != 2:
        raise ValueError("csr_matrix needs a 2-D input")
    rows, cols = np.nonzero(dense)
    data = dense[rows, cols]
    indptr = np.zeros(dense.shape[0] + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    data = _as_nd(data, dev)
    d = data._data.device
    return CSRNDArray(data, _idx(indptr, d), _idx(cols.astype(np.int64), d),
                      dense.shape)


def cast_storage(arr, stype):
    """`arr` in storage type `stype` ("default", "row_sparse", "csr")."""
    if stype == "default":
        return arr.todense() if isinstance(arr, BaseSparseNDArray) else arr
    if stype == "row_sparse":
        return arr if isinstance(arr, RowSparseNDArray) else \
            row_sparse_array(arr)
    if stype == "csr":
        return arr if isinstance(arr, CSRNDArray) else csr_matrix(arr)
    raise ValueError(stype)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An empty row_sparse or csr array of `shape` on `ctx`."""
    dev = to_device(ctx)
    dt = dtype_torch(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(
            NDArray._from_data(torch.zeros((0,) + tuple(shape[1:]), dtype=dt,
                                           device=dev)),
            NDArray._from_data(torch.zeros((0,), dtype=torch.int64,
                                           device=dev)), shape)
    if stype == "csr":
        return CSRNDArray(
            NDArray._from_data(torch.zeros((0,), dtype=dt, device=dev)),
            NDArray._from_data(torch.zeros((shape[0] + 1,),
                                           dtype=torch.int64, device=dev)),
            NDArray._from_data(torch.zeros((0,), dtype=torch.int64,
                                           device=dev)), shape)
    raise ValueError(stype)


def retain(rsp, indices):
    """The rows of `rsp` whose ids are in `indices`."""
    want = np.asarray(_host(indices)).astype(np.int64)
    have = _host(rsp.indices)
    mask = torch.from_numpy(np.isin(have, want)).to(rsp.device)
    return RowSparseNDArray(
        NDArray._from_data(rsp.data._data[mask]),
        NDArray._from_data(rsp.indices._data[mask]), rsp.shape, rsp.unique)
