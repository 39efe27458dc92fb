"""Graph sampling for DGL (`incubator_mxnet_tpu/contrib/graph.py`): the
reference's `_contrib_dgl_csr_neighbor_uniform_sample`,
`_contrib_dgl_csr_neighbor_non_uniform_sample`, `_contrib_dgl_subgraph`,
`_contrib_edge_id`, `_contrib_dgl_adjacency` and
`_contrib_dgl_graph_compact` over the port's `CSRNDArray`.

Neighbor sampling is data-dependent index-set work (hash sets, frontier
queues, draws without replacement), so it runs on the host in numpy,
as the reference's CPU-only kernels do, and its outputs are CPU arrays
padded to `max_num_vertices`. Seeds enter at layer 0; each vertex below
`num_hops` keeps at most `num_neighbor` of its out-edges (uniform
without replacement, or weighted by a per-vertex probability); new
endpoints join the frontier until `max_num_vertices`. Sampled subgraphs
keep the parent's edge ids as CSR values.
"""
from __future__ import annotations

import warnings

import numpy as np

import torch

from ..ndarray.ndarray import NDArray
from ..ndarray.sparse import CSRNDArray

__all__ = [
    "csr_neighbor_uniform_sample",
    "csr_neighbor_non_uniform_sample",
    "dgl_subgraph",
    "edge_id",
    "dgl_adjacency",
    "dgl_graph_compact",
]


def _host(a):
    """A CPU NDArray over numpy `a`."""
    return NDArray._from_data(torch.from_numpy(np.ascontiguousarray(a)))


def _as_np(x, dtype=None):
    if isinstance(x, NDArray):
        x = x.asnumpy()
    arr = np.asarray(x)
    return arr.astype(dtype) if dtype is not None else arr


def _csr_parts(csr):
    if not isinstance(csr, CSRNDArray):
        raise TypeError(f"expected CSRNDArray, got {type(csr).__name__}")
    return (
        _as_np(csr.data, np.int64),
        _as_np(csr.indices, np.int64),
        _as_np(csr.indptr, np.int64),
    )


def _sample_row(rng, cols, eids, num_neighbor, prob):
    """Keep at most `num_neighbor` of a vertex's out-edges
    (ref: GetUniformSample / GetNonUniformSample, dgl_graph.cc:452,495)."""
    ver_len = cols.shape[0]
    if ver_len <= num_neighbor:
        return cols, eids
    if prob is None:
        pick = rng.choice(ver_len, size=num_neighbor, replace=False)
    else:
        w = prob[cols].astype(np.float64)
        positive = np.nonzero(w > 0)[0]
        if positive.shape[0] <= num_neighbor:
            # without replacement, only positive-weight neighbors can be
            # drawn — keep exactly those
            pick = positive
        else:
            pick = rng.choice(ver_len, size=num_neighbor, replace=False,
                              p=w / w.sum())
    pick.sort()
    return cols[pick], eids[pick]


def _sample_subgraph(data, indices, indptr, seeds, prob, num_hops,
                     num_neighbor, max_num_vertices, rng):
    """One seed array -> (sample_id[max+1], sub CSR, prob or None, layer)
    (ref: SampleSubgraph, dgl_graph.cc:540)."""
    n = indptr.shape[0] - 1
    seeds = np.asarray(seeds, dtype=np.int64).ravel()
    if seeds.shape[0] > max_num_vertices:
        raise ValueError("more seed vertices than max_num_vertices")

    seen = {}
    frontier = []  # (vertex, layer) in discovery order; doubles as the queue
    for s in seeds:
        v = int(s)
        if v not in seen:
            seen[v] = 0
            frontier.append((v, 0))
    neigh = {}  # vertex -> (cols, eids) of its sampled out-edges
    idx = 0
    while idx < len(frontier) and len(seen) < max_num_vertices:
        v, layer = frontier[idx]
        idx += 1
        if layer >= num_hops:
            continue
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        cols, eids = _sample_row(rng, indices[lo:hi], data[lo:hi],
                                 num_neighbor, prob)
        neigh[v] = (cols, eids)
        for c in cols:
            if len(seen) >= max_num_vertices:
                break
            c = int(c)
            if c not in seen:
                seen[c] = layer + 1
                frontier.append((c, layer + 1))
    if any(layer < num_hops for _, layer in frontier[idx:]):
        warnings.warn(
            "sampling truncated at max_num_vertices; use fewer seeds or a "
            "smaller neighborhood")

    order = np.array(sorted(seen), dtype=np.int64)
    nv = order.shape[0]
    sample_id = np.zeros(max_num_vertices + 1, dtype=np.int64)
    sample_id[:nv] = order
    sample_id[max_num_vertices] = nv
    layer_out = np.zeros(max_num_vertices, dtype=np.int64)
    layer_out[:nv] = [seen[int(v)] for v in order]

    sub_indptr = np.zeros(max_num_vertices + 1, dtype=np.int64)
    col_chunks, eid_chunks = [], []
    for i, v in enumerate(order):
        cols, eids = neigh.get(int(v), (None, None))
        cnt = 0
        if cols is not None and cols.shape[0]:
            # when max_num_vertices truncated the frontier, some sampled
            # endpoints never entered the vertex set — drop those edges so
            # the subgraph is self-contained (the reference emits dangling
            # edges here, which its own graph_compact then rejects)
            keep = np.fromiter((int(c) in seen for c in cols), dtype=bool,
                               count=cols.shape[0])
            cols, eids = cols[keep], eids[keep]
            cnt = cols.shape[0]
            if cnt:
                col_chunks.append(cols)
                eid_chunks.append(eids)
        sub_indptr[i + 1] = sub_indptr[i] + cnt
    sub_indptr[nv + 1:] = sub_indptr[nv]
    sub_cols = (np.concatenate(col_chunks) if col_chunks
                else np.zeros(0, dtype=np.int64))
    sub_eids = (np.concatenate(eid_chunks) if eid_chunks
                else np.zeros(0, dtype=np.int64))
    sub_csr = CSRNDArray(_host(sub_eids), _host(sub_indptr),
                         _host(sub_cols), (max_num_vertices, n))

    prob_out = None
    if prob is not None:
        prob_out = np.zeros(max_num_vertices, dtype=np.float32)
        prob_out[:nv] = prob[order]
    return sample_id, sub_csr, prob_out, layer_out


def _check_square(indptr, csr):
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"graph CSR must be square, got {csr.shape}")


def csr_neighbor_uniform_sample(csr, *seed_arrays, num_hops=1, num_neighbor=2,
                                max_num_vertices=100, rng=None):
    """Sample subgraphs by uniform neighbor sampling
    (ref: _contrib_dgl_csr_neighbor_uniform_sample, dgl_graph.cc:758).

    Returns a flat list in the reference's output order: all sampled-vertex
    arrays (length max_num_vertices+1, last element = actual vertex count),
    then all sampled CSR subgraphs (original edge ids as values), then all
    layer arrays.
    """
    data, indices, indptr = _csr_parts(csr)
    _check_square(indptr, csr)
    rng = np.random.default_rng() if rng is None else rng
    ids, csrs, layers = [], [], []
    for seed in seed_arrays:
        sid, sub, _, layer = _sample_subgraph(
            data, indices, indptr, _as_np(seed, np.int64), None,
            num_hops, num_neighbor, max_num_vertices, rng)
        ids.append(_host(sid))
        csrs.append(sub)
        layers.append(_host(layer))
    return ids + csrs + layers


def csr_neighbor_non_uniform_sample(csr, probability, *seed_arrays,
                                    num_hops=1, num_neighbor=2,
                                    max_num_vertices=100, rng=None):
    """Weighted neighbor sampling: edge (u -> v) is kept with probability
    proportional to probability[v]
    (ref: _contrib_dgl_csr_neighbor_non_uniform_sample, dgl_graph.cc:852).

    Output order: sampled-vertex arrays, CSR subgraphs, per-vertex
    probability arrays, layer arrays.
    """
    data, indices, indptr = _csr_parts(csr)
    _check_square(indptr, csr)
    prob = _as_np(probability, np.float32).ravel()
    if prob.shape[0] != csr.shape[0]:
        raise ValueError("probability must have one entry per vertex")
    rng = np.random.default_rng() if rng is None else rng
    ids, csrs, probs, layers = [], [], [], []
    for seed in seed_arrays:
        sid, sub, p, layer = _sample_subgraph(
            data, indices, indptr, _as_np(seed, np.int64), prob,
            num_hops, num_neighbor, max_num_vertices, rng)
        ids.append(_host(sid))
        csrs.append(sub)
        probs.append(_host(p))
        layers.append(_host(layer))
    return ids + csrs + probs + layers


def dgl_subgraph(graph, *vertex_arrays, return_mapping=False):
    """Induced subgraph over each sorted vertex set: edges whose endpoints
    both lie in the set are kept, vertices renumbered to 0..len(v)-1, values
    renumbered to new edge ids 0..nnz-1; with return_mapping a second CSR
    carries the ORIGINAL edge ids (ref: _contrib_dgl_subgraph +
    GetSubgraph, dgl_graph.cc:1129,1053)."""
    data, indices, indptr = _csr_parts(graph)
    n = graph.shape[0]
    subs, mappings = [], []
    for varr in vertex_arrays:
        vids = _as_np(varr, np.int64).ravel()
        if vids.size and np.any(np.diff(vids) <= 0):
            raise ValueError(
                "the input vertex list has to be sorted and duplicate-free")
        if vids.size and (vids[0] < 0 or vids[-1] >= n):
            raise ValueError("vertex id out of range")
        old2new = {int(v): i for i, v in enumerate(vids)}
        m = vids.shape[0]
        sub_indptr = np.zeros(m + 1, dtype=np.int64)
        new_cols, orig_eids = [], []
        for i, v in enumerate(vids):
            lo, hi = int(indptr[v]), int(indptr[v + 1])
            for c, e in zip(indices[lo:hi], data[lo:hi]):
                nc = old2new.get(int(c))
                if nc is not None:
                    new_cols.append(nc)
                    orig_eids.append(int(e))
            sub_indptr[i + 1] = len(new_cols)
        new_cols = np.asarray(new_cols, dtype=np.int64)
        orig_eids = np.asarray(orig_eids, dtype=np.int64)
        new_eids = np.arange(new_cols.shape[0], dtype=np.int64)
        subs.append(CSRNDArray(_host(new_eids), _host(sub_indptr),
                               _host(new_cols), (m, m)))
        if return_mapping:
            mappings.append(CSRNDArray(
                _host(orig_eids), _host(sub_indptr.copy()),
                _host(new_cols.copy()), (m, m)))
    out = subs + mappings
    return out if len(out) > 1 else out[0]


def edge_id(csr, u, v):
    """output[i] = csr[u[i], v[i]] (the edge id) or -1 when absent
    (ref: _contrib_edge_id, dgl_graph.cc:1314)."""
    data, indices, indptr = _csr_parts(csr)
    uu = _as_np(u, np.int64).ravel()
    vv = _as_np(v, np.int64).ravel()
    if uu.shape != vv.shape:
        raise ValueError("u and v must have the same length")
    out = np.full(uu.shape[0], -1, dtype=np.int64)
    for i, (a, b) in enumerate(zip(uu, vv)):
        lo, hi = int(indptr[a]), int(indptr[a + 1])
        hit = np.nonzero(indices[lo:hi] == b)[0]
        if hit.size:
            out[i] = data[lo + int(hit[0])]
    return _host(out)


def dgl_adjacency(csr):
    """Edge-id CSR -> adjacency CSR with float32 ones as values
    (ref: _contrib_dgl_adjacency, dgl_graph.cc:1390)."""
    _, indices, indptr = _csr_parts(csr)
    ones = np.ones(indices.shape[0], dtype=np.float32)
    return CSRNDArray(_host(ones), _host(indptr.copy()),
                      _host(indices.copy()), csr.shape)


def dgl_graph_compact(*args, graph_sizes, return_mapping=False):
    """Strip the max_num_vertices padding from sampled subgraphs: rows/cols
    are renumbered into the compact 0..graph_size-1 space via the sampled
    vertex array; values become new edge ids (original ids via the mapping
    output) (ref: _contrib_dgl_graph_compact + CompactSubgraph,
    dgl_graph.cc:1565,1444)."""
    if len(args) % 2:
        raise ValueError("expected (graph, ..., vertex_ids, ...) pairs")
    num_g = len(args) // 2
    graphs, vid_arrays = args[:num_g], args[num_g:]
    if np.isscalar(graph_sizes):
        graph_sizes = (int(graph_sizes),) * num_g
    if len(graph_sizes) != num_g:
        raise ValueError("graph_sizes must have one entry per graph")
    subs, mappings = [], []
    for csr, vids_in, size in zip(graphs, vid_arrays, graph_sizes):
        data, indices, indptr = _csr_parts(csr)
        vids = _as_np(vids_in, np.int64).ravel()
        # last element of the sampled-vertex array = actual vertex count
        if int(vids[-1]) != size:
            raise ValueError(
                f"graph_sizes entry {size} disagrees with sampled vertex "
                f"count {int(vids[-1])}")
        old2new = {int(v): i for i, v in enumerate(vids[:size])}
        nnz = int(indptr[size])
        out_indptr = indptr[:size + 1].copy()
        out_cols = np.fromiter(
            (old2new[int(c)] for c in indices[:nnz]), dtype=np.int64,
            count=nnz)
        new_eids = np.arange(nnz, dtype=np.int64)
        subs.append(CSRNDArray(_host(new_eids), _host(out_indptr),
                               _host(out_cols), (size, size)))
        if return_mapping:
            mappings.append(CSRNDArray(
                _host(data[:nnz].copy()), _host(out_indptr.copy()),
                _host(out_cols.copy()), (size, size)))
    out = subs + mappings
    return out if len(out) > 1 else out[0]
