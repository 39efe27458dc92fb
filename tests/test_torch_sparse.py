"""The port's sparse storage and its consumers against the JAX package's,
on the CPU: row_sparse and csr storage (format checks, `cast_storage`,
`retain`, csr slicing, `tostype`), the three sparse `dot`s, the
elementwise ops, the nnz grid and `pad_row_ids`, the row-sparse gradient
of `Embedding(sparse_grad=True)` (index sets equal, values with
duplicates summed at rtol 1e-5, atol 1e-6), every lazy and densifying
optimizer path after 3 updates (rtol 1e-5, atol 1e-6, the update
tolerance of `tests/test_torch_optimizer.py`), the Trainer's lazy update
and `legacy_io`'s sparse entries both ways. JAX indices are int32 (x64
is off), the port's int64: values are compared, not dtypes."""
import struct
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu.ndarray import legacy_io as jleg
from incubator_mxnet_tpu.ndarray import sparse as jsp
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _dense(m, k, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(m, k) * (rng.rand(m, k) < density)).astype(np.float32)


def _np(x):
    return np.asarray(x.asnumpy())


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


def _pair(make):
    """`make(pkg, sparse_module)` in JAX and in the port (on the CPU)."""
    with CPU:
        return make(jnd, jsp), make(tnd, tsp)


# -- storage -------------------------------------------------------------------

STORAGE_CASES = {
    "csr from dense": lambda nd, sp: sp.csr_matrix(_dense(7, 5)),
    "csr from triple": lambda nd, sp: sp.csr_matrix(
        (np.array([1., 2., 3.], np.float32), np.array([0, 2, 1]),
         np.array([0, 2, 2, 3])), shape=(3, 4)),
    "rsp from dense": lambda nd, sp: sp.row_sparse_array(
        np.eye(6, 4, dtype=np.float32) * 3),
    "rsp from pair": lambda nd, sp: sp.row_sparse_array(
        (np.ones((2, 3), np.float32), [1, 4]), shape=(6, 3)),
    "cast csr": lambda nd, sp: sp.cast_storage(nd.array(_dense(5, 5)), "csr"),
    "cast rsp": lambda nd, sp: sp.cast_storage(nd.array(_dense(5, 5, 0.1)),
                                               "row_sparse"),
    "tostype csr": lambda nd, sp: nd.array(_dense(4, 6)).tostype("csr"),
    "tostype rsp": lambda nd, sp: nd.array(_dense(6, 3, 0.2)).tostype(
        "row_sparse"),
    "csr to rsp": lambda nd, sp: sp.csr_matrix(_dense(5, 4)).tostype(
        "row_sparse"),
    "retain": lambda nd, sp: sp.retain(sp.row_sparse_array(
        _dense(8, 3, 0.5, seed=3)), nd.array(np.array([0, 2, 3, 7]))),
    "zeros rsp": lambda nd, sp: sp.zeros("row_sparse", (4, 3)),
    "zeros csr": lambda nd, sp: sp.zeros("csr", (4, 3)),
    "csr slice": lambda nd, sp: sp.csr_matrix(_dense(8, 6))[2:6],
    "csr row": lambda nd, sp: sp.csr_matrix(_dense(8, 6))[-1],
    "csr empty slice": lambda nd, sp: sp.csr_matrix(_dense(4, 3))[3:1],
}


@pytest.mark.parametrize("case", sorted(STORAGE_CASES))
def test_storage_matches_jax(case):
    j, t = _pair(STORAGE_CASES[case])
    assert type(t).__name__ == type(j).__name__
    assert t.stype == j.stype and t.shape == j.shape
    assert t.nnz == j.nnz
    _close(t, j)
    for part in ("indices", "indptr"):
        if hasattr(j, part):
            np.testing.assert_array_equal(_np(getattr(t, part)),
                                          _np(getattr(j, part)))
    t.check_format()
    np.testing.assert_array_equal(_np(t.tostype("default")), _np(t))


BAD_FORMATS = {
    "rsp unsorted": lambda nd, sp: sp.RowSparseNDArray(
        nd.array(np.ones((2, 2), np.float32)), nd.array([3, 1]), (5, 2)),
    "rsp out of range": lambda nd, sp: sp.RowSparseNDArray(
        nd.array(np.ones((1, 2), np.float32)), nd.array([9]), (5, 2)),
    "rsp length": lambda nd, sp: sp.RowSparseNDArray(
        nd.array(np.ones((2, 2), np.float32)), nd.array([1]), (5, 2)),
    "csr indptr": lambda nd, sp: sp.CSRNDArray(
        nd.array(np.ones(2, np.float32)), nd.array([0, 1]),
        nd.array([0, 1]), (2, 3)),
    "csr column": lambda nd, sp: sp.CSRNDArray(
        nd.array(np.ones(1, np.float32)), nd.array([0, 1, 1]),
        nd.array([5]), (2, 3)),
}


@pytest.mark.parametrize("case", sorted(BAD_FORMATS))
def test_check_format_rejects_what_jax_rejects(case):
    # index parts go in as NDArrays: the JAX constructors fail on numpy
    # index arrays (ROADMAP Queue C); the port's take either
    with CPU:
        for nd, sp in ((jnd, jsp), (tnd, tsp)):
            with pytest.raises(ValueError):
                BAD_FORMATS[case](nd, sp).check_format()
        with pytest.raises(ValueError):
            BAD_FORMATS[case](np, tsp_np).check_format()
    with pytest.raises(IndexError):
        with CPU:
            tsp.csr_matrix(_dense(4, 3))[-9]


class tsp_np:
    """The port's constructors handed numpy parts."""
    RowSparseNDArray = staticmethod(lambda d, i, s: tsp.RowSparseNDArray(
        np.asarray(d), np.asarray(i), s))
    CSRNDArray = staticmethod(lambda d, p, i, s: tsp.CSRNDArray(
        np.asarray(d), np.asarray(p), np.asarray(i), s))


DOT_CASES = {
    "csr . dense": lambda nd, sp: sp.dot(sp.csr_matrix(_dense(6, 5)),
                                         nd.array(_dense(5, 3, 1.0, 1))),
    "csr^T . dense": lambda nd, sp: sp.dot(sp.csr_matrix(_dense(6, 5, 0.2)),
                                           nd.array(_dense(6, 3, 1.0, 2)),
                                           transpose_a=True),
    "dense . rsp": lambda nd, sp: sp.dot(nd.array(_dense(4, 6, 1.0, 3)),
                                         sp.row_sparse_array(
                                             _dense(6, 2, 0.4, 4))),
    "rsp . dense": lambda nd, sp: sp.dot(sp.row_sparse_array(
        _dense(5, 4, 0.4, 5)), nd.array(_dense(4, 2, 1.0, 6))),
}


@pytest.mark.parametrize("case", sorted(DOT_CASES))
def test_sparse_dot_matches_jax(case):
    j, t = _pair(DOT_CASES[case])
    assert type(t).__name__ == type(j).__name__ and t.shape == j.shape
    _close(t, j)
    if hasattr(j, "indices"):
        np.testing.assert_array_equal(_np(t.indices), _np(j.indices))


def _rsp(sp, rows, seed, total=7, width=3):
    rng = np.random.RandomState(seed)
    return sp.row_sparse_array((rng.rand(len(rows), width).astype(
        np.float32), rows), shape=(total, width))


ELEMWISE_CASES = {
    "add": lambda nd, sp: sp.add(_rsp(sp, [0, 3], 1), _rsp(sp, [3, 5], 2)),
    "subtract": lambda nd, sp: sp.subtract(_rsp(sp, [1, 2], 3),
                                           _rsp(sp, [2, 6], 4)),
    "multiply": lambda nd, sp: sp.multiply(_rsp(sp, [1, 4], 5),
                                           _rsp(sp, [4], 6)),
    "scalar": lambda nd, sp: _rsp(sp, [2, 5], 7) * 2.5,
    "add_n": lambda nd, sp: sp.add_n(_rsp(sp, [0], 8), _rsp(sp, [6], 9),
                                     _rsp(sp, [0, 6], 10)),
    "dense fallback": lambda nd, sp: sp.add(_rsp(sp, [1], 11),
                                            nd.array(_dense(7, 3, 1.0, 12))),
    "operator +": lambda nd, sp: _rsp(sp, [0, 1], 13) + _rsp(sp, [1], 14),
}


@pytest.mark.parametrize("case", sorted(ELEMWISE_CASES))
def test_elementwise_matches_jax(case):
    j, t = _pair(ELEMWISE_CASES[case])
    assert type(t).__name__ == type(j).__name__
    _close(t, j)
    if hasattr(j, "indices"):
        np.testing.assert_array_equal(_np(t.indices), _np(j.indices))


# -- the nnz grid ----------------------------------------------------------------

@pytest.mark.parametrize("bucketing", ["0", "1"])
def test_nnz_grid_matches_jax(monkeypatch, bucketing):
    monkeypatch.setenv("MXTPU_SPARSE_NNZ_BUCKETING", bucketing)
    for n in (0, 1, 15, 16, 17, 31, 32, 33, 1000):
        assert tsp.bucket_nnz(n) == jsp.bucket_nnz(n)
    for ids, force in (([], False), ([3], False), ([1, 2, 9], False),
                       (list(range(17)), False), ([4, 5], True),
                       (list(range(16)), False)):
        j, jn = jsp.pad_row_ids(ids, force=force)
        t, tn = tsp.pad_row_ids(ids, force=force)
        np.testing.assert_array_equal(t, j)
        assert t.dtype == np.int64 and tn == jn
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    idx = np.array([0, 2, 3, 6, 7])
    jd, ji = jsp._pad_nnz(jnp_array(data), jnp_array(idx))
    td, ti = tsp._pad_nnz(torch.from_numpy(data), torch.from_numpy(idx))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def jnp_array(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


# -- the row-sparse embedding gradient ---------------------------------------------

def _embedding_grad(pkg, ag, nn, weight, ids, dense_use=False):
    """The weight gradient of sum(emb(ids)^2) (+ sum(w^2) with
    `dense_use`) through Embedding(sparse_grad=True)."""
    emb = nn.Embedding(weight.shape[0], weight.shape[1], sparse_grad=True)
    emb.initialize(pkg.init.Zero(), ctx=pkg.cpu())
    emb.weight.set_data(weight)
    x = pkg.nd.array(ids.astype(np.float32))
    with ag.record():
        out = emb(x)
        loss = (out * out).sum()
        if dense_use:
            w = emb.weight.data()
            loss = loss + (w * w).sum()
    loss.backward()
    return emb.weight.grad()


@pytest.mark.parametrize("dense_use", [False, True],
                         ids=["sparse", "sparse+dense"])
def test_sparse_embedding_grad_matches_jax(dense_use):
    rng = np.random.RandomState(0)
    weight = rng.randn(50, 4).astype(np.float32)
    ids = np.array([3, 7, 3, 41, 7, 3])
    with CPU:
        j = _embedding_grad(jmx, jag, jmx.gluon.nn, weight, ids, dense_use)
        t = _embedding_grad(tmx, tag, tmx.gluon.nn, weight, ids, dense_use)
    assert type(t).__name__ == type(j).__name__
    if not dense_use:
        np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
        np.testing.assert_array_equal(_np(t.indices), [3, 7, 41])
        assert t.unique  # a lazy update skips the duplicate fold
        np.testing.assert_allclose(_np(t.data), _np(j.data), rtol=RTOL,
                                   atol=ATOL)
    _close(t, j)


def _two_graphs_grad(pkg, ag, weight, ids1, ids2, req):
    """Two losses recorded in one scope, then one backward each, with
    the weight's grad_req `req`: the weight gradient afterwards."""
    emb = pkg.gluon.nn.Embedding(weight.shape[0], weight.shape[1],
                                 sparse_grad=True)
    emb.initialize(pkg.init.Zero(), ctx=pkg.cpu())
    emb.weight.set_data(weight)
    emb.weight.grad_req = req
    with ag.record():
        o1 = emb(pkg.nd.array(ids1.astype(np.float32)))
        l1 = (o1 * o1).sum()
        o2 = emb(pkg.nd.array(ids2.astype(np.float32)))
        l2 = (o2 * o2 * o2).sum()
    l1.backward()
    l2.backward()
    return emb.weight.grad()


@pytest.mark.parametrize("req", ["add", "write"])
def test_sparse_embedding_two_graphs_in_one_scope_match_jax(req):
    """Each backward reaches its own graph's lookup: "add" sums both
    losses' rows, "write" keeps the second loss's (and warns, as the
    dense overwrite does)."""
    rng = np.random.RandomState(1)
    weight = rng.randn(12, 3).astype(np.float32)
    ids1, ids2 = np.array([1, 5, 5, 9]), np.array([5, 2, 2, 11])
    with CPU:
        j = _two_graphs_grad(jmx, jag, weight, ids1, ids2, req)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t = _two_graphs_grad(tmx, tag, weight, ids1, ids2, req)
    overwrote = [w for w in caught if issubclass(w.category, RuntimeWarning)
                 and "overwritten" in str(w.message)]
    assert len(overwrote) == (req == "write")
    want = [1, 2, 5, 9, 11] if req == "add" else [2, 5, 11]
    np.testing.assert_array_equal(np.unique(_np(t.indices)), want)
    _close(t, j)


def test_sparse_embedding_tensor_call_is_dense():
    """Called with tensors (a train step's forward) the lookup is the
    dense gather, as JAX's jitted path is."""
    emb = tmx.gluon.nn.Embedding(10, 2, sparse_grad=True)
    emb.initialize(device="cpu")
    out = emb(torch.tensor([1, 4]))
    (out * out).sum().backward()
    g = emb.weight.tensor().grad
    assert g is not None and g.shape == (10, 2)
    with CPU:
        with tag.record():
            y = emb(tnd.array([1.0, 4.0]))
        y.backward()
    assert isinstance(emb.weight.grad(), tsp.RowSparseNDArray)


def test_sparse_embedding_grad_api_and_buffers():
    """autograd.grad sees the sparse gradient; a dense gradient displaces
    the sparse buffer; zero_grad empties it again (JAX's
    test_sparse_then_dense_grad_keeps_parameter_buffer)."""
    with CPU:
        emb = tmx.gluon.nn.Embedding(6, 2, sparse_grad=True)
        emb.initialize(tmx.init.Normal(0.1))
        w = emb.weight.data()
        x = tnd.array([1.0, 3.0])
        with tag.record():
            loss = (emb(x) ** 2).sum()
        (g,) = tag.grad([loss], [w])
        assert isinstance(g, tsp.RowSparseNDArray)
        np.testing.assert_allclose(_np(g)[[1, 3]], 2 * _np(w)[[1, 3]],
                                   rtol=RTOL)
        assert isinstance(emb.weight.grad(), tsp.RowSparseNDArray)
        assert emb.weight.grad().nnz == 0
        with tag.record():
            loss = (emb(x) ** 2).sum()
        loss.backward()
        assert emb.weight.grad().nnz == 2
        with tag.record():
            loss2 = (w * w).sum()
        loss2.backward()
        g = emb.weight.grad()
        assert isinstance(g, tnd.NDArray) and np.abs(_np(g)).sum() > 0
        emb.weight.zero_grad()
        assert isinstance(emb.weight.grad(), tsp.RowSparseNDArray)
        assert np.abs(_np(emb.weight.grad())).sum() == 0


# -- the optimizers' lazy and densifying paths -------------------------------------

OPT_CASES = {
    "sgd lazy": ("sgd", dict(learning_rate=0.1, wd=0.01)),
    "sgd lazy momentum": ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                      wd=0.01, clip_gradient=0.8)),
    "sgd dense": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01,
                              lazy_update=False)),
    "adam lazy": ("adam", dict(learning_rate=0.05, wd=0.01)),
    "adam dense": ("adam", dict(learning_rate=0.05, wd=0.01,
                                lazy_update=False)),
    "adagrad": ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    "sgd multi-precision": ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                        multi_precision=True)),
}


def _opt_run(pkg, name, kw, updater=False):
    """3 lazy updates of a (9, 3) weight by row-sparse gradients (a
    duplicated row id in the second) with rescale_grad 0.5; returns the
    weight and the state arrays."""
    mp = kw.get("multi_precision")
    rng = np.random.RandomState(5)
    w0 = rng.randn(9, 3).astype(np.float32)
    opt = pkg.optimizer.create(name, rescale_grad=0.5, **kw)
    dt = "float16" if mp else "float32"
    w = pkg.nd.array(w0, dtype=dt)
    upd = pkg.optimizer.get_updater(opt)
    state = None if updater else opt.create_state_multi_precision(0, w)
    for rows in ([1, 4, 6], [2, 6, 2], [0, 8]):
        data = rng.randn(len(rows), 3).astype(np.float32)
        g = pkg.nd.sparse.row_sparse_array((data, rows), shape=(9, 3))
        if mp:
            g = pkg.nd.sparse.RowSparseNDArray(
                pkg.nd.array(data, dtype=dt), g.indices, (9, 3))
        if updater:
            upd(0, g, w)
        else:
            opt.update_multi_precision(0, w, g, state)
    state = upd.states[0] if updater else state
    flat = state if isinstance(state, tuple) else (state,)
    return w, [s for s in flat if s is not None]


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_lazy_optimizer_matches_jax(case):
    name, kw = OPT_CASES[case]
    with CPU:
        jw, js = _opt_run(jmx, name, kw)
        tw, ts = _opt_run(tmx, name, kw)
    assert len(js) == len(ts)
    for a, b in zip(ts, js):  # states (the float32 master under mp)
        _close(a, b)
    if kw.get("multi_precision"):
        np.testing.assert_allclose(_np(tw), _np(jw), rtol=1e-3)
    else:
        _close(tw, jw)


def test_updater_densifies_for_optimizers_without_a_sparse_path():
    """RMSProp has no lazy path: the port's Updater hands it the dense
    gradient (bit-equal to a dense push); a row-sparse gradient reaches
    SGD's lazy path through the Updater as JAX's does."""
    def run(sparse):
        with CPU:
            opt = tmx.optimizer.RMSProp(learning_rate=0.01)
            upd = tmx.optimizer.get_updater(opt)
            w = tnd.array(np.ones((5, 2), np.float32))
            g = tsp.row_sparse_array((np.ones((2, 2), np.float32), [1, 3]),
                                     shape=(5, 2))
            upd(0, g if sparse else g.todense(), w)
            return _np(w)
    np.testing.assert_array_equal(run(True), run(False))
    with CPU:
        jw, _ = _opt_run(jmx, "sgd", dict(learning_rate=0.1), updater=True)
        tw, _ = _opt_run(tmx, "sgd", dict(learning_rate=0.1), updater=True)
    _close(tw, jw)


def test_stochastic_rounding_densifies(monkeypatch):
    """The stochastic-rounding path has no lazy form: a row-sparse
    gradient gives the bits a dense one gives."""
    outs = []
    for sparse in (True, False):
        with CPU:
            opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                    stochastic_rounding=True)
            w = tnd.array(np.linspace(-1, 1, 12, dtype=np.float32)
                          .reshape(4, 3), dtype="bfloat16")
            st = opt.create_state_multi_precision(0, w)
            g = tsp.row_sparse_array((np.full((2, 3), 0.3, np.float32),
                                      [0, 2]), shape=(4, 3))
            opt.update_multi_precision(0, w, g if sparse else g.todense(),
                                       st)
            outs.append(w._data.float().numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


# -- the Trainer's lazy update -------------------------------------------------------

def _trainer_run(pkg, opt_name, steps=2):
    """Embedding(sparse_grad=True) -> Dense, `steps` Trainer steps; returns
    (table before, table after, dense weight after, losses)."""
    nn = pkg.gluon.nn
    rng = np.random.RandomState(1)
    net = nn.HybridSequential(prefix="lazy_")
    with net.name_scope():
        net.add(nn.Embedding(20, 3, sparse_grad=True))
        net.add(nn.Dense(2, in_units=6))
    net.initialize(pkg.init.Zero(), ctx=pkg.cpu())
    params = net.collect_params()
    for name in sorted(params.keys()):
        p = params[name]
        p.set_data(pkg.nd.array(rng.randn(*p.shape).astype(np.float32)))
    before = _np(params["lazy_embedding0_weight"].data()).copy()
    trainer = pkg.gluon.Trainer(params, opt_name,
                                {"learning_rate": 0.1, "wd": 0.01})
    losses = []
    for ids in ([[2, 5], [5, 7]], [[1, 2], [2, 2]])[:steps]:
        x = pkg.nd.array(np.array(ids, np.float32))
        with pkg.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        trainer.step(2)
        losses.append(float(_np(loss)))
    return (before, _np(params["lazy_embedding0_weight"].data()),
            _np(params["lazy_dense0_weight"].data()), losses)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_trainer_lazy_update_matches_jax(opt_name):
    with CPU:
        jb, jt, jd, jl = _trainer_run(jmx, opt_name)
        tb, tt, td, tl = _trainer_run(tmx, opt_name)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    np.testing.assert_allclose(tt, jt, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td, jd, rtol=RTOL, atol=ATOL)
    untouched = np.setdiff1d(np.arange(20), [1, 2, 5, 7])
    np.testing.assert_array_equal(tt[untouched], tb[untouched])


# -- legacy_io: sparse entries both ways ------------------------------------------

def _rsp_blob(data, idx, shape, name="emb"):
    """A reference-format container holding one row_sparse entry."""
    return b"".join([
        struct.pack("<QQQ", 0x112, 0, 1), struct.pack("<I", 0xF993FAC9),
        struct.pack("<i", 1),
        struct.pack("<I", 2), struct.pack("<qq", *data.shape),
        struct.pack("<I", 2), struct.pack("<qq", *shape),
        struct.pack("<ii", 1, 0), struct.pack("<i", 0),
        struct.pack("<i", 6), struct.pack("<I", 1),
        struct.pack("<q", idx.size), data.tobytes(), idx.tobytes(),
        struct.pack("<Q", 1), struct.pack("<Q", len(name)), name.encode()])


def _csr_blob(data, indptr, idx, shape, name="m"):
    """A reference-format container holding one csr entry (aux order on
    disk: indptr, then indices)."""
    return b"".join([
        struct.pack("<QQQ", 0x112, 0, 1), struct.pack("<I", 0xF993FAC9),
        struct.pack("<i", 2),
        struct.pack("<I", 1), struct.pack("<q", data.size),
        struct.pack("<I", 2), struct.pack("<qq", *shape),
        struct.pack("<ii", 1, 0), struct.pack("<i", 0),
        struct.pack("<i", 6), struct.pack("<I", 1),
        struct.pack("<q", indptr.size),
        struct.pack("<i", 6), struct.pack("<I", 1),
        struct.pack("<q", idx.size),
        data.tobytes(), indptr.tobytes(), idx.tobytes(),
        struct.pack("<Q", 1), struct.pack("<Q", len(name)), name.encode()])


def test_legacy_io_sparse_both_ways():
    data = np.arange(6, dtype=np.float32).reshape(2, 3) + 1
    idx = np.array([1, 3], np.int64)
    cdata = np.array([1., 2., 3.], np.float32)
    indptr = np.array([0, 2, 2, 3], np.int64)
    cidx = np.array([0, 3, 1], np.int64)
    for blob, key in ((_rsp_blob(data, idx, (5, 3)), "emb"),
                      (_csr_blob(cdata, indptr, cidx, (3, 4)), "m")):
        j = jleg.load_mxnet_params(blob)[key]
        t = tnd.legacy_io.load_mxnet_params(blob, ctx=CPU)[key]
        assert type(t).__name__ == type(j).__name__
        assert t.shape == j.shape
        _close(t, j)
        np.testing.assert_array_equal(_np(t.indices), _np(j.indices))
    # a sparse array saves dense, byte for byte as the JAX package saves it
    with CPU:
        jsave = jleg.save_mxnet_params(None, {
            "r": jsp.row_sparse_array((data, idx), shape=(5, 3)),
            "c": jsp.csr_matrix((cdata, cidx, indptr), shape=(3, 4))})
        tsave = tnd.legacy_io.save_mxnet_params(None, {
            "r": tsp.row_sparse_array((data, idx), shape=(5, 3)),
            "c": tsp.csr_matrix((cdata, cidx, indptr), shape=(3, 4))})
    assert tsave == jsave


def test_matrix_factorization_loop_repeats_bit_for_bit():
    """examples/matrix_factorization.py's loop (lazy Adam, 512 x 256 x 16,
    4 epochs; `chip_smoke.mf_run`) run twice on the CPU gives the same
    per-epoch RMSEs and the same row-sparse gradient of the user table,
    bit for bit: the port's sparse sums add in one order every run."""
    import chip_smoke

    runs = []
    threads = torch.get_num_threads()
    # one intra-op thread: beside the suite's other workers the default
    # pool made the loop's small ops 40x slower
    torch.set_num_threads(1)
    try:
        for _ in range(2):
            rmse, grad = chip_smoke.mf_run(tmx.cpu())
            runs.append((rmse, grad.indices.asnumpy(), grad.data.asnumpy()))
    finally:
        torch.set_num_threads(threads)
    (r0, i0, d0), (r1, i1, d1) = runs
    assert r0 == r1
    np.testing.assert_array_equal(i0, i1)
    assert d0.tobytes() == d1.tobytes()
