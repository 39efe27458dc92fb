"""Gluon utilities: carrying weights between nets."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_numpy_params"]


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
