"""The `nd.contrib` namespace (`incubator_mxnet_tpu/ndarray/contrib.py`):
every `_contrib_*` registry op under its short name (`nd.contrib.box_nms`,
`nd.contrib.ROIAlign`, ...), `boolean_mask`, `index_copy`,
`index_array`, `arange_like`, and the DGL graph-sampling entry points
over `contrib/graph.py` (host CSR sampling)."""
from __future__ import annotations

import torch

from ..ops.registry import OP_REGISTRY
from . import register as _register
from .ndarray import NDArray


def boolean_mask(data, index, axis=0):
    return _register.invoke(OP_REGISTRY["boolean_mask"], (data, index),
                            dict(axis=axis))


def index_copy(old_tensor, index_vector, new_tensor):
    return _register.invoke(OP_REGISTRY["_contrib_index_copy"],
                            (old_tensor, index_vector, new_tensor), {})


def index_array(data, axes=None):
    """(..., len(axes)) int64 coordinates of every element of `data`."""
    shape = data.shape
    axes_ = tuple(axes) if axes is not None else tuple(range(len(shape)))
    dev = data._data.device
    grids = torch.meshgrid(*[torch.arange(shape[a], device=dev)
                             for a in axes_], indexing="ij")
    return NDArray._from_data(torch.stack(grids, -1))


def arange_like(data, start=0.0, step=1.0, axis=None):
    return _register.invoke(OP_REGISTRY["_arange_like"], (data,),
                            dict(start=start, step=step, axis=axis))


# -- DGL graph sampling (host CSR, contrib/graph.py) ------------------------

def dgl_csr_neighbor_uniform_sample(csr, *seeds, **kwargs):
    from ..contrib import graph as _graph
    kwargs.pop("num_args", None)
    return _graph.csr_neighbor_uniform_sample(csr, *seeds, **kwargs)


def dgl_csr_neighbor_non_uniform_sample(csr, probability, *seeds, **kwargs):
    from ..contrib import graph as _graph
    kwargs.pop("num_args", None)
    return _graph.csr_neighbor_non_uniform_sample(csr, probability, *seeds,
                                                  **kwargs)


def dgl_subgraph(graph, *vertex_arrays, **kwargs):
    from ..contrib import graph as _graph
    kwargs.pop("num_args", None)
    return _graph.dgl_subgraph(graph, *vertex_arrays, **kwargs)


def edge_id(csr, u, v):
    from ..contrib import graph as _graph
    return _graph.edge_id(csr, u, v)


def dgl_adjacency(csr):
    from ..contrib import graph as _graph
    return _graph.dgl_adjacency(csr)


def dgl_graph_compact(*args, **kwargs):
    from ..contrib import graph as _graph
    kwargs.pop("num_args", None)
    return _graph.dgl_graph_compact(*args, **kwargs)


def _install_contrib_ops():
    """Every `_contrib_*` registry op here under its short name (the
    reference's `nd.contrib` code generation)."""
    for name, op in list(OP_REGISTRY.items()):
        if not name.startswith("_contrib_"):
            continue
        short = name[len("_contrib_"):]
        if short in globals():
            continue

        def make(opdef):
            def f(*args, **kwargs):
                return _register.invoke(opdef, args, kwargs)
            return f

        fn = make(op)
        fn.__name__ = short
        fn.__doc__ = op.fn.__doc__
        globals()[short] = fn


_install_contrib_ops()
