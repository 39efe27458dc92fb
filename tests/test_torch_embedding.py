"""The port's sharded embedding tier against the JAX package's, on the
CPU: server-initialized rows bit-identical to JAX's, pull plans (dedup,
bucket padding, the sticky bucket) and blocks equal, pushes through SGD
and lazy momentum on the servers equal at rtol 1e-5, atol 1e-6; the
port's prefetch bit-identical to its blocking path, snapshot / restore
bit-identical, the remote `SparseEmbedding`'s exact gradients; DLRM
(`[30, 47]`, `tests/test_embedding.py`'s size) with the remote and the
local arm, 4 steps from weights carried from JAX (`save_parameters`,
and the servers' deterministic init), losses at rtol 1e-5 and the final
tables and towers at rtol 1e-5 / atol 1e-6; and the port's
`bench.py --recommender --assert` at its defaults, its nine exact
counters equal to `ci/perf_baseline.json`'s. Every fleet is closed by
the test that opens it."""
import importlib
import json
import os

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import embedding as jemb
from incubator_mxnet_tpu_torch import embedding as temb
from incubator_mxnet_tpu_torch.ps import ParameterServer, PSClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


class _Fleet:
    """An in-process fleet of `n` shard servers of one package."""

    def __init__(self, emb, n, prefetch=False):
        self.servers, self.svc = emb.launch_local_fleet(n)
        if prefetch != self.svc._prefetch_on:
            self.svc.close()
            mod = __import__(emb.__name__.rsplit(".", 1)[0] + ".ps",
                             fromlist=["PSClient"])
            self.svc = emb.ShardedEmbeddingService(
                clients=[mod.PSClient("127.0.0.1", s.port)
                         for s in self.servers], prefetch=prefetch)

    def __enter__(self):
        return self.svc

    def __exit__(self, *exc):
        self.svc.close()
        for s in self.servers:
            try:
                s.shutdown()
            except Exception:
                pass


def _both(n=2, prefetch=False):
    return _Fleet(jemb, n, prefetch), _Fleet(temb, n, prefetch)


@pytest.mark.parametrize("shards", [1, 3])
def test_server_init_bit_identical_to_jax(shards):
    jf, tf = _both(shards)
    with jf as js, tf as ts:
        for svc in (js, ts):
            svc.table("emb", 23, 5, seed=7)
            svc.table("zero", 9, 2, init="zeros")
        for name in ("emb", "zero"):
            a, b = ts.full_table(name), js.full_table(name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        emb = ts.full_table("emb")
    with _Fleet(temb, 2) as other:  # rows depend on (seed, global id) only
        other.table("emb", 23, 5, seed=7)
        np.testing.assert_array_equal(other.full_table("emb"), emb)


@pytest.mark.parametrize("bucketing", ["0", "1"])
def test_pull_plans_and_blocks_equal_jax(monkeypatch, bucketing):
    monkeypatch.setenv("MXTPU_SPARSE_NNZ_BUCKETING", bucketing)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 60, size=n).astype(np.int64)
               for n in (40, 6, 25, 3)]
    jf, tf = _both()
    with jf as js, tf as ts:
        for svc in (js, ts):
            svc.table("a", 60, 4, seed=1)
            svc.table("b", 31, 4, seed=2)
        for raw in batches:
            req = [("a", raw), ("b", raw % 31)]
            jb, jp = js.pull(req)
            tb, tp = ts.pull(req)
            for (_n, ji, jn, jids), (_m, ti, tn, tids) in zip(jp, tp):
                np.testing.assert_array_equal(ti, ji)
                np.testing.assert_array_equal(tids, jids)
                assert tn == jn
            for a, b in zip(tb, jb):
                np.testing.assert_array_equal(a, b)
            block, inv, n = ts.pull_per_key("a", raw)
            np.testing.assert_array_equal(block[inv],
                                          ts.full_table("a")[raw])


@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["sgd", "momentum"])
def test_push_matches_jax(momentum):
    rng = np.random.RandomState(4)
    pushes = []
    for _ in range(3):
        ids = np.unique(rng.randint(0, 19, size=8)).astype(np.int64)
        pushes.append((ids, rng.randn(ids.size, 4).astype(np.float32)))
    jf, tf = _both()
    with jf as js, tf as ts:
        for svc, mx in ((js, jmx), (ts, tmx)):
            svc.table("emb", 19, 4, seed=8)
            svc.set_optimizer(mx.optimizer.SGD(
                learning_rate=0.1, momentum=momentum, wd=0.01,
                rescale_grad=0.5))
            for ids, g in pushes:
                svc.push_grads(grads=[("emb", ids, g)])
            svc.flush()
        np.testing.assert_allclose(ts.full_table("emb"),
                                   js.full_table("emb"), rtol=RTOL,
                                   atol=ATOL)
        untouched = np.setdiff1d(np.arange(19),
                                 np.concatenate([p[0] for p in pushes]))
        if untouched.size:
            with _Fleet(temb, 2) as fresh:
                fresh.table("emb", 19, 4, seed=8)
                np.testing.assert_array_equal(
                    ts.full_table("emb")[untouched],
                    fresh.full_table("emb")[untouched])


def test_prefetch_bit_identical_to_blocking():
    finals = {}
    for prefetch in (False, True):
        with _Fleet(temb, 2, prefetch=prefetch) as svc:
            t = svc.table("emb", 40, 4, seed=11)
            svc.set_optimizer(tmx.optimizer.SGD(learning_rate=0.2,
                                                rescale_grad=1.0))
            rng = np.random.RandomState(2)
            batches = [rng.randint(0, 40, size=12).astype(np.int64)
                       for _ in range(5)]
            if prefetch:
                svc.prefetch([("emb", batches[0])])
            for i, raw in enumerate(batches):
                block, inv, n = t.pull(raw)
                svc.push_grads(grads=[("emb", np.unique(raw),
                                       block[:n] * 0.1)])
                if prefetch and i + 1 < len(batches):
                    svc.prefetch([("emb", batches[i + 1])])
            svc.flush()
            finals[prefetch] = svc.full_table("emb")
    np.testing.assert_array_equal(finals[False], finals[True])


def test_snapshot_restore_shard_bit_identical(tmp_path):
    f = _Fleet(temb, 2)
    with f as svc:
        svc.table("emb", 19, 4, seed=8)
        svc.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1,
                                            rescale_grad=1.0))
        rng = np.random.RandomState(5)
        for _ in range(3):
            ids = np.unique(rng.randint(0, 19, size=8)).astype(np.int64)
            svc.push_grads(grads=[("emb", ids, rng.randn(ids.size, 4)
                                   .astype(np.float32))])
        svc.snapshot(str(tmp_path))
        reference = svc.full_table("emb")
        f.servers[0].shutdown()
        repl = ParameterServer(num_workers=1, host="127.0.0.1", port=0)
        f.servers.append(repl)
        svc.restore_shard(0, str(tmp_path), PSClient("127.0.0.1", repl.port))
        np.testing.assert_array_equal(svc.full_table("emb"), reference)
        svc.push_grads(grads=[("emb", np.array([0], np.int64),
                               np.ones((1, 4), np.float32))])
        np.testing.assert_allclose(svc.full_table("emb")[0],
                                   reference[0] - 0.1, rtol=1e-6)
        with open(str(tmp_path / "shard-1") + ".sha256", "r+b") as m:
            m.seek(20)
            m.write(b"0")
        with pytest.raises(RuntimeError, match="verification"):
            svc.restore_shard(1, str(tmp_path), PSClient(
                "127.0.0.1", repl.port))


def test_counters_signatures_and_worker_errors(monkeypatch):
    from incubator_mxnet_tpu_torch import telemetry
    from incubator_mxnet_tpu_torch.telemetry import compilereg

    monkeypatch.setenv("MXTPU_SPARSE_NNZ_BUCKETING", "1")
    telemetry.REGISTRY.reset()
    compilereg.reset()
    telemetry.enable()
    try:
        with _Fleet(temb, 2, prefetch=True) as svc:
            svc.table("emb", 50, 4, seed=4)
            raw = np.array([1, 1, 8, 49, 8, 30], np.int64)
            b1, i1, n1 = svc.pull_per_key("emb", raw)
            (b2,), plan = svc.pull([("emb", raw)])
            np.testing.assert_array_equal(b1[i1], b2[plan[0][1]])
            assert n1 == plan[0][2] == 4 and b2.shape == (16, 4)
            fam = telemetry.REGISTRY.get(temb.PULL_RPCS_TOTAL)
            assert fam.value(path="per_key") == 2
            assert fam.value(path="batched") == 2
            svc.prefetch([("emb", raw)])
            svc.flush()
            svc.pull([("emb", raw)])
            hits = telemetry.REGISTRY.get(temb.PREFETCH_HITS_TOTAL)
            assert sum(c.value for _l, c in hits.series()) == 1
            rng = np.random.RandomState(0)
            for n in (17, 20, 25, 31, 19):  # all in the 32 bucket
                svc.pull([("emb", rng.randint(0, 50, size=64)[:n])])
            reg = compilereg.snapshot()["embedding.pull"]
            sigs = {e["signature"] for e in reg["entries"]}
            assert {s for s in sigs if "(32, 4)" in s}
            assert reg["retraces"] == len(sigs) - 1
            svc._jobs.put(("push", [("nope", np.array([0]),
                                     np.zeros((1, 4), np.float32))]))
            with pytest.raises(RuntimeError, match="nope"):
                svc.flush()
    finally:
        telemetry.disable()
        telemetry.REGISTRY.reset()
        compilereg.reset()


def test_remote_sparse_embedding_exact_grads():
    from incubator_mxnet_tpu_torch import autograd, gluon, nd

    with _Fleet(temb, 2) as svc, CPU:
        lr = 0.25
        svc.set_optimizer(tmx.optimizer.SGD(learning_rate=lr,
                                            rescale_grad=1.0))
        layer = gluon.contrib.nn.SparseEmbedding(17, 3, service=svc,
                                                 table="emb", seed=6)
        before = svc.full_table("emb")
        x = nd.array(np.array([2, 5, 2, 11], np.float32))
        with autograd.record():
            y = layer(x)
            loss = (y * y).sum()
        loss.backward()
        assert y.shape == (4, 3)
        svc.push_grads()
        after = svc.full_table("emb")
        counts = {2: 2, 5: 1, 11: 1}
        for r in range(17):
            np.testing.assert_allclose(
                after[r], before[r] * (1.0 - 2.0 * lr * counts.get(r, 0)),
                rtol=1e-6, atol=1e-7)
    local = gluon.contrib.nn.SparseEmbedding(10, 4)
    local.initialize(ctx=CPU)
    assert local.weight.grad_stype == "row_sparse"


# -- DLRM from carried weights ------------------------------------------------------

def _ids(rng):
    """A (8, 2) id batch with 6 unique ids a field, two of them twice:
    one row count a step, so the JAX side compiles its eager ops once."""
    return np.stack([rng.permutation(rng.permutation(30)[:6][
        [0, 1, 2, 3, 4, 5, 0, 1]]) for _f in range(2)], axis=1)


def _dlrm_run(pkg, svc, params_file, save):
    """4 steps of DLRM([30, 47]); returns (losses, tables, towers)."""
    from_pkg = pkg
    with from_pkg.cpu():
        if save:
            from_pkg.random.seed(42)
        models = importlib.import_module(from_pkg.__name__ + ".models")
        net = models.DLRM([30, 47], num_dense=3, embed_dim=4,
                          bottom_units=(8,), top_units=(8,),
                          service=svc, seed=5)
        # zeros, then numpy draws set on the JAX side (a JAX Xavier draw
        # compiles once per shape)
        net.initialize(from_pkg.init.Zero())
        # shapes resolved by a recorded forward at the steps' shapes (the
        # JAX side then compiles each recorded op once); the pulled
        # blocks it stashed are dropped
        with from_pkg.autograd.record():
            net(from_pkg.nd.array(np.zeros((8, 3), np.float32)),
                _ids(np.random.RandomState(0)))
        if svc is not None:
            svc._pending_grads.clear()
        if save:
            rng = np.random.RandomState(7)
            params = net._collect_params_with_prefix()
            for name in sorted(params):
                p = params[name]
                p.set_data(from_pkg.nd.array(
                    rng.uniform(-0.4, 0.4, p.shape).astype(np.float32)))
            net.save_parameters(params_file)
        else:
            net.load_parameters(params_file)
        if svc is not None:
            svc.set_optimizer(from_pkg.optimizer.SGD(learning_rate=0.05))
        tr = from_pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.05})
        if svc is not None:
            tr.attach_sparse_service(svc)
        loss_fn = from_pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        rng = np.random.RandomState(3)
        losses = []
        for _ in range(4):
            dense = from_pkg.nd.array(rng.randn(8, 3).astype(np.float32))
            ids = _ids(rng)
            lab = from_pkg.nd.array(rng.randint(0, 2, size=(8, 1))
                                    .astype(np.float32))
            with from_pkg.autograd.record():
                loss = loss_fn(net(dense, ids), lab).mean()
            loss.backward()
            tr.step(1)
            losses.append(float(loss.asnumpy()))
        if svc is not None:
            svc.flush()
            tables = [svc.full_table(f"dlrm_f{i}") for i in range(2)]
        else:
            tables = []
        towers = {k: np.asarray(p.data().asnumpy()) for k, p in
                  net._collect_params_with_prefix().items()}
        return losses, tables, towers


@pytest.mark.parametrize("arm", ["remote", "local"])
def test_dlrm_matches_jax_from_carried_weights(arm, tmp_path):
    path = str(tmp_path / "dlrm.params")
    jf, tf = _both()
    with jf as js, tf as ts:
        want = _dlrm_run(jmx, js if arm == "remote" else None, path, True)
        got = _dlrm_run(tmx, ts if arm == "remote" else None, path, False)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert sorted(got[2]) == sorted(want[2])
    if arm == "local":
        assert any(k.startswith("sparse_arm") for k in got[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_recommender_bench_counters_equal_baseline(capsys):
    from incubator_mxnet_tpu_torch import bench, telemetry
    from incubator_mxnet_tpu_torch.telemetry import compilereg, ledger

    try:
        out = bench.recommender_main(assert_mode=True, ctx=CPU)
    finally:
        # the bench turns telemetry on and counts retraces in the
        # process's registry: leave it as the next test expects it
        telemetry.disable()
        telemetry.REGISTRY.reset()
        compilereg.reset()
        ledger.reset()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    with open(os.path.join(ROOT, "ci", "perf_baseline.json")) as f:
        base = json.load(f)["metrics"]
    for key in ("dedup_factor", "full_table_bytes", "num_servers",
                "num_tables", "rpc_per_step", "rpc_per_step_naive",
                "steady_retraces", "weights_match",
                "worker_embedding_bytes"):
        assert out[key] == base[f"recommender.{key}"]["value"], key
