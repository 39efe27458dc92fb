"""Gluon utilities (`incubator_mxnet_tpu/gluon/utils.py`): splitting a
batch over contexts, clipping gradients by their global norm, carrying
weights between nets and checking a file's SHA-1. `download` raises:
the port fetches nothing."""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..ndarray.ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "load_numpy_params", "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """`num_slice` slices of `data` along `batch_axis` (the last takes the
    remainder unless `even_split` demands equal ones)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(f"data size {size} not divisible by {num_slice}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split `data` over `ctx_list`, each slice on its context."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale `arrays` (NDArrays, in place) so that their joint 2-norm is
    at most `max_norm`; returns the norm before scaling (one host
    read)."""
    with torch.no_grad():
        total = sum(torch.sum(torch.square(a._data.float()))
                    for a in arrays)
        norm = float(torch.sqrt(total))
        scale = max_norm / (norm + 1e-8)
        if scale < 1.0:
            for a in arrays:
                a._data.mul_(scale)
    return norm


def load_numpy_params(net, arrays, prefix=""):
    """Copy `arrays` ({full name: numpy array}, the values of another
    net's `collect_params()`, e.g. the JAX package's) into `net`'s
    parameters. Names are matched with `prefix` stripped from the keys of
    `arrays` and `net.prefix` from `net`'s: the top-level counters differ
    between processes and packages ('resnet0_' here, 'resnet1_' there).
    The two sets of names and every shape must be equal. A parameter not
    materialized yet takes the array's shape on its `initialize` device."""
    params = net.collect_params()
    mine = {n[len(net.prefix):] if n.startswith(net.prefix) else n: p
            for n, p in params.items()}
    theirs = {n[len(prefix):] if n.startswith(prefix) else n: a
              for n, a in arrays.items()}
    if set(mine) != set(theirs):
        raise ValueError(f"parameter names differ: only here "
                         f"{sorted(set(mine) - set(theirs))[:5]}, only in "
                         f"the arrays {sorted(set(theirs) - set(mine))[:5]}")
    for name, p in mine.items():
        a = np.asarray(theirs[name])
        if p.shape is not None and p._shape_known() and \
                tuple(p.shape) != a.shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {p.shape}")
        p.set_data(torch.tensor(a))


def check_sha1(filename, sha1_hash):
    """Whether the SHA-1 of the file's bytes is `sha1_hash` (hex)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise RuntimeError("download: the port fetches nothing over the "
                       "network; place the file locally instead")
