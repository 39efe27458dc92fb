"""The port's kvstore against the JAX package's, on the CPU: the local
store (init / push / pull / pushpull, list keys, the updater), 2-bit
compression with error feedback, `row_sparse_pull`, the sparse push
through an updater and without one; then 'dist_async_server' in one
process (the parameter server in a thread of this process) under
`Trainer(update_on_kvstore=True)`, and a local store under the Trainer,
each held to a local-update run; `create`'s refusals and the TCP
heartbeat."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import kvstore as jkv
from incubator_mxnet_tpu_torch import kvstore as tkv

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return np.asarray(x.asnumpy())


def _rsp(pkg, rows, data, shape):
    return pkg.nd.sparse.row_sparse_array(
        (np.asarray(data, np.float32), rows), shape=shape)


def _pull(kv, pkg, key, shape):
    out = pkg.nd.zeros(shape)
    kv.pull(key, out=out)
    return _np(out)


def _scn_init_pull(pkg, kvs):
    kv = kvs.create("local")
    kv.init(3, pkg.nd.ones((2, 3)))
    keys = ["a", "b"]
    kv.init(keys, [pkg.nd.ones((2,)), pkg.nd.ones((3,)) * 2])
    outs = [pkg.nd.zeros((2,)), pkg.nd.zeros((3,))]
    kv.pull(keys, out=outs)
    return [_pull(kv, pkg, 3, (2, 3))] + [_np(o) for o in outs]


def _scn_updater(pkg, kvs):
    kv = kvs.create("local")
    kv.init("w", pkg.nd.zeros((2, 2)))
    kv.set_updater(lambda key, grad, weight: weight.__iadd__(grad))
    kv.push("w", [pkg.nd.ones((2, 2)), pkg.nd.ones((2, 2)) * 2])
    kv2 = kvs.create("device")
    kv2.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0,
                                        momentum=0.9, wd=0.01))
    kv2.init("w", pkg.nd.array(np.linspace(-1, 1, 6, dtype=np.float32)))
    for k in range(3):
        kv2.push("w", pkg.nd.array(np.full(6, 0.5 + k, np.float32)))
    return [_pull(kv, pkg, "w", (2, 2)), _pull(kv2, pkg, "w", (6,))]


def _scn_pushpull_reset(pkg, kvs):
    kv = kvs.create("local")
    keys = ["a", "b"]
    outs = [pkg.nd.zeros((2,)), pkg.nd.zeros((2,))]
    got = []
    for _ in range(2):
        kv.pushpull(keys, [pkg.nd.ones((2,)), pkg.nd.ones((2,)) * 2],
                    out=outs)
        got += [_np(o).copy() for o in outs]
    return got


def _scn_compression(pkg, kvs):
    kv = kvs.create("device")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("w", pkg.nd.zeros((4,)))
    got = []
    rng = np.random.RandomState(0)
    for _ in range(6):
        kv.push("w", pkg.nd.array(rng.randn(4).astype(np.float32) * 0.4))
        got.append(_pull(kv, pkg, "w", (4,)))
    return got


def _scn_row_sparse_pull(pkg, kvs):
    kv = kvs.create("local")
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    kv.init("emb", pkg.nd.array(table))
    out = pkg.nd.sparse.zeros("row_sparse", (4, 3))
    kv.row_sparse_pull("emb", out=out, row_ids=pkg.nd.array([1, 3]))
    dense = pkg.nd.zeros((4, 3))
    kv.row_sparse_pull("emb", out=dense, row_ids=pkg.nd.array([0, 2]))
    return [_np(out), _np(out.indices), _np(dense)]


def _scn_sparse_push(pkg, kvs):
    kv = kvs.create("local")
    kv.init("emb", pkg.nd.ones((5, 3)))
    kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                       rescale_grad=1.0))
    rng = np.random.RandomState(3)
    for rows in ([1, 3], [3, 4], []):
        kv.push("emb", _rsp(pkg, np.asarray(rows, np.int64),
                            rng.randn(len(rows), 3).reshape(-1, 3), (5, 3)))
    kv2 = kvs.create("local")
    kv2.init("e", pkg.nd.ones((3, 2)))
    kv2.push("e", [_rsp(pkg, [0], [[1.0, 1.0]], (3, 2)),
                   _rsp(pkg, [0, 2], [[1.0, 1.0], [2.0, 2.0]], (3, 2))])
    return [_pull(kv, pkg, "emb", (5, 3)), _pull(kv2, pkg, "e", (3, 2))]


SCENARIOS = {"init and pull": _scn_init_pull, "updater": _scn_updater,
             "pushpull reset": _scn_pushpull_reset,
             "2-bit compression": _scn_compression,
             "row_sparse_pull": _scn_row_sparse_pull,
             "sparse push": _scn_sparse_push}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_local_store_matches_jax(case):
    with CPU:
        j = SCENARIOS[case](jmx, jkv)
        t = SCENARIOS[case](tmx, tkv)
    assert len(j) == len(t)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_two_bit_codec_matches_jax():
    """Packed payload, decode and residual equal JAX's on one random
    gradient; the payload is 4 codes a byte."""
    import jax.numpy as jnp
    import torch

    g = np.random.RandomState(0).randn(131).astype(np.float32)
    jc, tc = jkv.TwoBitCompressor(0.5), tkv.TwoBitCompressor(0.5)
    for _ in range(2):
        jp, jn = jc.encode("k", jnp.asarray(g))
        tp, tn = tc.encode("k", torch.from_numpy(g))
        assert tn == jn and tp.dtype == torch.uint8
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tc.decode(tp, g.shape).numpy(),
                                      np.asarray(jc.decode(jp, g.shape)))
        np.testing.assert_allclose(tc._residual["k"].numpy(),
                                   np.asarray(jc._residual["k"]), rtol=RTOL,
                                   atol=ATOL)
    assert tp.numel() == (131 + 3) // 4


# -- the Trainer over a store ---------------------------------------------------

def _net_run(kvstore=None, update_on_kvstore=None, steps=3):
    """A Dense -> Dense net plus a row-sparse embedding, 3 Trainer steps
    (SGD with momentum); returns the final weights by name."""
    from incubator_mxnet_tpu_torch import autograd, gluon, nd

    rng = np.random.RandomState(4)
    with CPU:
        emb = gluon.nn.Embedding(12, 3, sparse_grad=True,
                                 prefix="kvemb_")
        net = gluon.nn.HybridSequential(prefix="kvnet_")
        with net.name_scope():
            net.add(gluon.nn.Dense(4, in_units=3, activation="relu"))
            net.add(gluon.nn.Dense(1, in_units=4))
        params = net.collect_params()
        params.update(emb.collect_params())
        params.initialize(tmx.init.Zero())
        for name in sorted(params.keys()):
            params[name].set_data(rng.randn(*params[name].shape)
                                  .astype(np.float32))
        kw = {} if kvstore is None else {"kvstore": kvstore}
        if update_on_kvstore is not None:
            kw["update_on_kvstore"] = update_on_kvstore
        tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                           "momentum": 0.9, "wd": 0.01},
                           **kw)
        for _ in range(steps):
            ids = nd.array(rng.randint(0, 12, size=(6,)).astype(np.float32))
            with autograd.record():
                loss = (net(emb(ids)) ** 2).mean()
            loss.backward()
            tr.step(6)
        return {n: _np(p.data()) for n, p in params.items()}, tr


@pytest.fixture
def ephemeral_ps(monkeypatch):
    """The in-process parameter server on a free loopback port (the
    default, 9923, may be taken by another test process)."""
    monkeypatch.setenv("MXTPU_PS_ADDR", "127.0.0.1:0")


@pytest.mark.parametrize("mode", ["dist_async_server", "local on store",
                                  "allreduce on a store"])
def test_trainer_over_kvstore_matches_local_update(mode, ephemeral_ps):
    want, _ = _net_run()
    if mode == "dist_async_server":
        got, tr = _net_run("dist_async_server")
        assert tr._update_on_kvstore
        assert isinstance(tr._kvstore, tkv.KVStoreDistAsyncServer)
        tr._kvstore.close()
    elif mode == "local on store":
        got, tr = _net_run("local", update_on_kvstore=True)
        assert tr._update_on_kvstore and type(tr._kvstore) is tkv.KVStore
    else:
        got, tr = _net_run(tkv.create("local"))
        assert not tr._update_on_kvstore
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_dist_async_server_store_direct(ephemeral_ps):
    """Sparse pushes ride push_rows and apply lazily on the server; list
    pushpulls batch into push_many; row_sparse_pull fetches the rows."""
    with CPU:
        kv = tkv.create("dist_async_server")
        try:
            assert kv.rank == 0 and kv.num_workers == 1
            kv.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5,
                                               rescale_grad=1.0))
            kv.init("emb", tmx.nd.ones((4, 3)))
            kv.push("emb", _rsp(tmx, [1, 3], np.ones((2, 3)), (4, 3)))
            w = _pull(kv, tmx, "emb", (4, 3))
            np.testing.assert_allclose(w[[1, 3]], 0.5)
            assert (w[[0, 2]] == 1).all()
            kv.init(["a", "b"], [tmx.nd.zeros((2,)), tmx.nd.zeros((3,))])
            outs = [tmx.nd.zeros((2,)), tmx.nd.zeros((3,))]
            kv.pushpull(["a", "b"], [tmx.nd.ones((2,)), tmx.nd.ones((3,))],
                        out=outs)
            np.testing.assert_allclose(_np(outs[0]), -0.5)
            out = tmx.nd.sparse.zeros("row_sparse", (4, 3))
            kv.row_sparse_pull("emb", out=out, row_ids=tmx.nd.array([3, 0,
                                                                     3]))
            np.testing.assert_allclose(_np(out.data), w[[3, 0, 3]])
        finally:
            kv.close()


def test_create_refuses_collective_stores():
    for name in ("dist_sync", "dist_device_sync", "dist_async"):
        with pytest.raises(NotImplementedError, match="Queue A 4"):
            tkv.create(name)
    kv, upd = tkv.create_kvstore_for_module("local", 1, {})
    assert kv is None and not upd
    kv, upd = tkv.create_kvstore_for_module("device", 2, {})
    assert isinstance(kv, tkv.KVStore) and upd
    assert tmx.kv is tkv


def test_tcp_heartbeat_counts_dead_peers():
    hb = tkv._TcpHeartbeat(0, 2, "127.0.0.1", 0, interval=0.05,
                           timeout=0.3)
    try:
        # the observer's and the server's startup grace have passed
        hb._created -= 10
        hb._server._start_time -= 10
        assert hb.num_dead() == 1  # rank 1 never beat
        hb._client.heartbeat(1)
        assert hb.num_dead() == 0
    finally:
        hb.stop()
