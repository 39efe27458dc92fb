"""The port's parameter server (`ps.py`, `kvstore_server.py`) on the CPU:
the wire codec's bytes equal the JAX package's `_enc` for the same
objects (bfloat16 included, which the port carries as a torch tensor),
the commands of `tests/test_ps.py` on the port's server and client
(first-writer init, async and sync pushes, pull_rows, barrier, the
error path, server-side optimizer state, HMAC, loopback bind,
heartbeats, push_many, membership: join / leave / growth at a barrier,
the dedup window, the server role), and the wire between packages: a
port client against a JAX server and a JAX client against a port
server, with no optimizer on the server (a pickled optimizer does not
cross packages)."""
import os
import socket
import subprocess
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import ps as jps
from incubator_mxnet_tpu_torch import ps as tps
from incubator_mxnet_tpu_torch.ps import ParameterServer, PSClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _enc(mod, obj):
    out = []
    mod._enc(obj, out)
    return b"".join(out)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the codec --------------------------------------------------------------------

_BF16 = np.array([[1.5, -2.25, 3.0], [0.1, 1e-3, -7.0]], np.float32)
CODEC_CASES = {
    "scalars": (None, True, False, 0, -7, 2**40, np.int64(5), 1.5,
                np.float32(0.25), "ké", b"\x00\x01"),
    "arrays": [np.arange(12, dtype=np.float32).reshape(3, 4),
               np.array([1, -2], np.int64), np.zeros((0, 3), np.float64),
               np.array(3, np.int32), np.array([True, False])],
    "nested": {"a": [1, (2.0, "x")], 3: {"k": np.ones(2, np.uint8)},
               "frame": ("mut", "host:1:0", 7, "push", "w",
                         np.ones(3, np.float32), False, None)},
    "bfloat16": _BF16.astype(ml_dtypes.bfloat16),
}


@pytest.mark.parametrize("case", sorted(CODEC_CASES))
def test_codec_bytes_equal_jax(case):
    obj = CODEC_CASES[case]
    want = _enc(jps, obj)
    assert _enc(tps, obj) == want
    if case == "bfloat16":
        # the port's own bfloat16 arrays are torch tensors
        t = torch.from_numpy(_BF16).to(torch.bfloat16)
        assert _enc(tps, t) == want
        got, _ = tps._dec(want, 0)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, t)
        back, _ = jps._dec(_enc(tps, t), 0)
        np.testing.assert_array_equal(back.astype(np.float32),
                                      obj.astype(np.float32))
        return
    # the port decodes what JAX encodes into the same values, and back
    got, _ = tps._dec(want, 0)
    assert _enc(jps, got) == want
    assert _enc(tps, torch.from_numpy(np.arange(6, dtype=np.float32))) == \
        _enc(jps, np.arange(6, dtype=np.float32))


def test_codec_rejects_what_jax_rejects():
    for bad in (object(), {1, 2}, np.array([object()]),
                np.zeros(2, dtype="V4")):
        with pytest.raises(TypeError):
            _enc(tps, bad)
        with pytest.raises(TypeError):
            _enc(jps, bad)
    with pytest.raises(ValueError, match="bad PS wire tag"):
        tps._dec(b"Z", 0)


def test_optimizer_blob_hmac_rejected_on_mismatch(monkeypatch):
    monkeypatch.delenv("MXTPU_PS_SECRET", raising=False)
    blob = tps._sign_blob(b"payload")
    assert tps._verify_blob(blob) == b"payload"
    monkeypatch.setattr(tps, "_PROCESS_SECRET", b"x" * 32)
    with pytest.raises(PermissionError, match="MXTPU_PS_SECRET"):
        tps._verify_blob(blob)
    monkeypatch.setenv("MXTPU_PS_SECRET", "job")
    signed = tps._sign_blob(b"p")
    assert jps._verify_blob(signed) == b"p"  # one secret, one MAC


# -- the commands on the port's server ------------------------------------------------

@pytest.fixture
def server2():
    srv = ParameterServer(num_workers=2, host="127.0.0.1", port=0)
    clients = [PSClient("127.0.0.1", srv.port) for _ in range(2)]
    yield srv, clients
    for c in clients:
        c.close()
    srv.shutdown()


def test_init_push_pull_and_errors(server2):
    srv, (c0, c1) = server2
    c0.init("w", np.ones(3, np.float32))
    c1.init("w", np.full(3, 9.0, np.float32))  # first writer wins
    np.testing.assert_array_equal(c1.pull("w"), np.ones(3, np.float32))
    c0.push("w", np.full(3, 2.0, np.float32))  # no optimizer: accumulate
    np.testing.assert_array_equal(c1.pull("w"), np.full(3, 3.0, np.float32))
    c0.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0))
    c0.push("w", np.ones(3, np.float32))  # async: applied at once
    np.testing.assert_allclose(c1.pull("w"), 2.9, rtol=1e-6)
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    c0.init("emb", w)
    np.testing.assert_array_equal(c1.pull_rows("emb", np.array([1, 3])),
                                  w[[1, 3]])
    with pytest.raises(RuntimeError, match="KeyError"):
        c0.pull("missing")
    assert sorted(c0.keys()) == ["emb", "w"]


def test_sync_push_and_barrier(server2):
    srv, (c0, c1) = server2
    c0.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0))
    c0.init("w", np.ones(2, np.float32))
    t = threading.Thread(
        target=lambda: c1.push("w", np.ones(2, np.float32), sync=True))
    t.start()
    c0.push("w", np.ones(2, np.float32), sync=True)
    t.join(timeout=30)
    assert not t.is_alive()
    np.testing.assert_allclose(c0.pull("w"), 0.8, rtol=1e-6)
    order = []
    t = threading.Thread(target=lambda: (c1.barrier(),
                                         order.append("released")))
    t.start()
    assert not order
    c0.barrier()
    t.join(timeout=30)
    assert order == ["released"]


def test_server_side_optimizer_state(server2):
    srv, (c0, _) = server2
    c0.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                       rescale_grad=1.0))
    c0.init(0, np.zeros(2, np.float32))
    c0.push(0, np.ones(2, np.float32))
    blob = c0.get_optimizer_states()
    states = __import__("pickle").loads(blob)
    np.testing.assert_allclose(states[0], -0.1, rtol=1e-6)
    c0.set_optimizer_attrs({"lr": 0.2})
    c0.push(0, np.ones(2, np.float32))
    # momentum survived the attribute change: -0.09 - 0.2
    np.testing.assert_allclose(c0.pull(0), -0.1 - 0.29, rtol=1e-6)
    with pytest.raises(RuntimeError, match="AttributeError"):
        c0.set_optimizer_attrs({"no_such_knob": 1})
    c0.set_optimizer_states(blob)


def test_push_rows_apply_lazily_on_the_host(server2):
    srv, (c0, _) = server2
    c0.init("emb", np.ones((5, 2), np.float32))
    c0.push_rows("emb", np.array([0, 2, 0]), np.ones((3, 2), np.float32))
    np.testing.assert_array_equal(
        c0.pull("emb"), [[3, 3], [1, 1], [2, 2], [1, 1], [1, 1]])
    c0.set_optimizer(tmx.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                       rescale_grad=1.0))
    c0.push_rows_multi(["emb"], [np.array([1, 4])],
                       [np.ones((2, 2), np.float32)])
    got = c0.pull("emb")
    np.testing.assert_allclose(got[[1, 4]], 0.5)
    np.testing.assert_array_equal(got[[0, 2, 3]], [[3, 3], [2, 2], [1, 1]])
    assert isinstance(srv._store["emb"], torch.Tensor)
    assert srv._store["emb"].device.type == "cpu"


def test_push_many_matches_per_key_pushes(server2):
    srv, (c0, c1) = server2
    c0.init("a", np.zeros(3, np.float32))
    c0.init("b", np.full(2, 10.0, np.float32))
    c0.push_many(["a", "b"], [np.ones(3, np.float32),
                              np.full(2, 2.0, np.float32)])
    a, b = c0.pull_many(["a", "b"])
    np.testing.assert_array_equal(a, np.ones(3, np.float32))
    np.testing.assert_array_equal(b, np.full(2, 12.0, np.float32))
    ts = [threading.Thread(target=c.push_many, args=(
        ["a", "b"], [s * np.ones(3, np.float32), s * np.ones(2, np.float32)]),
        kwargs={"sync": True}) for c, s in ((c0, 1.0), (c1, 2.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    a2, b2 = c0.pull_many(["a", "b"])
    np.testing.assert_array_equal(a2, 4 * np.ones(3, np.float32))
    np.testing.assert_array_equal(b2, np.full(2, 15.0, np.float32))
    assert srv._versions["a"] == 2 and srv._versions["b"] == 2


def test_membership_join_leave_and_growth(server2, monkeypatch):
    monkeypatch.setenv("MXTPU_PS_SYNC_TIMEOUT", "30")
    srv, (c0, c1) = server2
    srv._max_workers = 3
    c0.join(0)
    c1.join(1)
    assert srv._epoch == 0
    c2 = PSClient("127.0.0.1", srv.port, instance="w2")
    info = c2.join(2, wait=False)
    assert info["pending"] and srv.num_workers == 2
    t = threading.Thread(target=c0.barrier)
    t.start()
    c1.barrier()
    t.join(timeout=30)
    assert not t.is_alive()
    assert srv.num_workers == 3 and srv._epoch == 1
    assert c0.epoch == 1 and c1.epoch == 1
    assert c2.wait_admitted()["num_workers"] == 3 and c2.epoch == 1
    assert c2.leave() == 2  # the quorum shrinks at once
    assert c0.membership()["quorum"] == 2
    c2.close()
    with pytest.raises(tps.JoinRejectedError, match="MXTPU_MAX_WORKERS"):
        from incubator_mxnet_tpu_torch.resilience import RetryPolicy
        c0.join(5, wait=False,
                policy=RetryPolicy(max_attempts=1, base_delay=0.01))


def test_stale_epoch_is_fenced(server2):
    srv, (c0, c1) = server2
    c0.join(0)
    c0.init("w", np.zeros(2, np.float32))
    srv._epoch += 1  # a membership change c0 has not seen
    with pytest.raises(tps.StaleEpochError):
        c0.push("w", np.ones(2, np.float32), sync=True)
    c0.membership()
    assert c0.epoch == srv._epoch


def test_dedup_window_applies_a_retransmit_once(server2):
    srv, (c0, _) = server2
    c0.init("w", np.zeros(2, np.float32))
    frame = ("mut", "client-x", 1, "push", "w", np.ones(2, np.float32),
             False, None)
    for _ in range(3):  # the same (client, seq) three times
        tps._send_msg(c0._sock, frame)
        assert tps._recv_msg(c0._sock) == ("ok",)
    np.testing.assert_array_equal(c0.pull("w"), np.ones(2, np.float32))


def test_heartbeats_and_loopback_bind():
    import time

    srv = ParameterServer(num_workers=3, host="127.0.0.1", port=0)
    c0 = PSClient("127.0.0.1", srv.port)
    try:
        c0.heartbeat(0)
        c0.heartbeat(1)
        assert c0.num_dead(0, timeout=5.0) == 0
        time.sleep(0.05)
        assert c0.num_dead(0, timeout=0.01) >= 1
        assert c0.num_dead(2, timeout=5.0) == 0
    finally:
        c0.stop_server()
        c0.close()
    s = ParameterServer(num_workers=1, port=0)
    try:
        assert s._sock.getsockname()[0] != "0.0.0.0"
    finally:
        s.shutdown()


def test_kvstore_server_role_and_module_entry(monkeypatch):
    from incubator_mxnet_tpu_torch.kvstore_server import KVStoreServer

    monkeypatch.setenv("MXTPU_PS_ADDR", "127.0.0.1:0")
    srv = KVStoreServer(num_workers=1)
    t = threading.Thread(target=srv.run, daemon=True)
    t.start()
    c = PSClient("127.0.0.1", srv._server.port)
    c.init("w", np.ones((3,), np.float32))
    np.testing.assert_array_equal(c.pull("w"), np.ones(3, np.float32))
    c.stop_server()
    t.join(timeout=10)
    assert not t.is_alive()
    c.close()
    port = _free_port()
    env = dict(os.environ, MXTPU_PS_ADDR=f"127.0.0.1:{port}",
               MXTPU_NUM_WORKERS="1", PYTHONPATH=ROOT)
    env.pop("MXTPU_ROLE", None)
    p = subprocess.Popen([sys.executable, "-m",
                          "incubator_mxnet_tpu_torch.kvstore_server"],
                         env=env, cwd=ROOT)
    try:
        c = PSClient("127.0.0.1", port)
        c.init("k", np.full((2,), 7, np.float32))
        np.testing.assert_array_equal(c.pull("k"), np.full(2, 7, np.float32))
        c.stop_server()
        c.close()
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()


# -- the wire between packages ---------------------------------------------------------

@pytest.mark.parametrize("server_pkg,client_pkg",
                         [(jps, tps), (tps, jps)], ids=["port client to JAX "
                                                        "server",
                                                        "JAX client to port "
                                                        "server"])
def test_wire_between_packages(server_pkg, client_pkg):
    srv = server_pkg.ParameterServer(num_workers=1, host="127.0.0.1", port=0)
    c = client_pkg.PSClient("127.0.0.1", srv.port)
    try:
        w = np.arange(12, dtype=np.float32).reshape(4, 3)
        c.init("emb", w)
        c.push("emb", np.ones((4, 3), np.float32))
        np.testing.assert_array_equal(c.pull("emb"), w + 1)
        c.init_rows("t", 5, 2, "float32", ("uniform", 0.05, 3, 1, 2))
        rows = c.pull_rows_multi(["emb", "t"], [np.array([3, 0]),
                                                np.array([4, 1, 4])])
        np.testing.assert_array_equal(rows[0], (w + 1)[[3, 0]])
        ref = client_pkg.ParameterServer  # the rows the spec defines
        assert rows[1].shape == (3, 2)
        c.push_rows_multi(["t"], [np.array([1, 1])],
                          [np.ones((2, 2), np.float32)])
        after = c.pull("t")
        np.testing.assert_allclose(after[1], rows[1][1] + 2, rtol=1e-6)
        c.push_rows("emb", np.array([2]), np.full((1, 3), 5, np.float32))
        np.testing.assert_array_equal(c.pull_rows("emb", np.array([2])),
                                      (w + 1)[[2]] + 5)
        manifest = c.state_manifest()
        assert sorted(manifest["files"]) == ["emb", "t"]
        boot = c.bootstrap()
        np.testing.assert_array_equal(boot["t"], after)
        assert ref is not None
    finally:
        c.stop_server()
        c.close()
        srv.shutdown()


def test_init_rows_bit_identical_to_jax_server():
    """Server-initialized rows depend only on (seed, global row id): a
    port server's shard equals a JAX server's, bit for bit."""
    servers = [m.ParameterServer(num_workers=1, host="127.0.0.1", port=0)
               for m in (jps, tps)]
    try:
        got = []
        for srv in servers:
            c = tps.PSClient("127.0.0.1", srv.port)
            c.init_rows("t", 7, 5, "float32", ("uniform", 0.05, 11, 1, 3))
            c.init_rows("z", 3, 2, "float32", ("zeros",))
            got.append((c.pull("t"), c.pull("z")))
            c.close()
        for a, b in zip(*got):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    finally:
        for srv in servers:
            srv.shutdown()
