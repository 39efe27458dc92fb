"""Datasets (`incubator_mxnet_tpu/gluon/data/dataset.py`): indexable
sources with filter / take / transform combinators. One mapping wrapper
(`_Mapped`) backs both transform flavors. `RecordFileDataset` waits for
the data layer (ROADMAP Queue A 6).
"""
from __future__ import annotations

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset"]


class Dataset:
    """Random-access sample source: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    # -- combinators -------------------------------------------------------
    def filter(self, fn):
        """Materialized subset of samples where fn(sample) is true."""
        return SimpleDataset([s for s in self if fn(s)])

    def take(self, count):
        """Materialized first min(count, len) samples."""
        return SimpleDataset(list(self)[:count])

    def transform(self, fn, lazy=True):
        """Apply fn to every sample (tuple samples are splatted)."""
        mapped = _Mapped(self, fn)
        return mapped if lazy else SimpleDataset(list(mapped))

    def transform_first(self, fn, lazy=True):
        """Apply fn to only the FIRST element of each tuple sample (the
        standard augment-data-not-label pattern)."""
        def first_only(x, *rest):
            return (fn(x),) + rest if rest else fn(x)

        return self.transform(first_only, lazy)


class SimpleDataset(Dataset):
    """Wrap any indexable container."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _Mapped(Dataset):
    """Lazy per-sample function application."""

    def __init__(self, source, fn):
        self._source = source
        self._fn = fn

    def __len__(self):
        return len(self._source)

    def __getitem__(self, idx):
        sample = self._source[idx]
        return self._fn(*sample) if isinstance(sample, tuple) \
            else self._fn(sample)


class ArrayDataset(Dataset):
    """Zip N equal-length arrays into tuple samples (single array: bare
    samples). NDArrays are snapshotted to numpy once up front so indexing
    is host-cheap."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        lengths = {len(a) for a in arrays}
        if len(lengths) != 1:
            raise ValueError(f"all arrays must share a length, got {lengths}")
        self._columns = [a.asnumpy() if isinstance(a, NDArray) else a
                         for a in arrays]

    def __len__(self):
        return len(self._columns[0])

    def __getitem__(self, idx):
        row = tuple(col[idx] for col in self._columns)
        return row[0] if len(row) == 1 else row

