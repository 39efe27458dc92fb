"""Serving fleet of the PyTorch port against the JAX package: the request
journal's epoch fence and duplicate suppression (event for event), mid-
stream failover resuming token-identically to the JAX `generate`, the
failover budget, rolling restarts and the SIGTERM drain with nothing
dropped, the `replica.rpc` requeue, the HTTP gateway (streaming, healthz,
metrics, 400/404/429/503, traceparent and the access log), the
`tools/chaos_serving.py` scenarios run on the port's fleet (failover on
the pinned kill schedule, with the JAX fleet's counts; rolling; wire)
with the lost-request and broken-chain negatives, and the traced
failover held by `tools/trace_merge.py --fleet --check`.

Weights are the JAX package's, bit-identical (`params_from_numpy`);
the port runs on the CPU through the kernels' plain versions. Every
engine is `warm()`ed before it joins a fleet, as on the card."""
import http.client
import json
import os
import signal
import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu.resilience import fault as jfault
from incubator_mxnet_tpu.serving import FleetRouter as JFleetRouter
from incubator_mxnet_tpu.serving import RequestJournal as JRequestJournal
from incubator_mxnet_tpu.serving import ServingEngine as JServingEngine
from incubator_mxnet_tpu.telemetry import slo as jslo
from incubator_mxnet_tpu_torch.models import transformer as ttfm
from incubator_mxnet_tpu_torch.resilience import fault as tfault
from incubator_mxnet_tpu_torch.resilience import preemption as tpre
from incubator_mxnet_tpu_torch.serving import (
    FleetRouter, RequestJournal, ServingEngine, ServingGateway)
from incubator_mxnet_tpu_torch.telemetry import distributed as tdist
from incubator_mxnet_tpu_torch.telemetry import recorder as trec
from incubator_mxnet_tpu_torch.telemetry import slo as tslo

TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "tools")
# tests/test_serving_fleet.py's model, and tools/chaos_serving.py's
FLEET_CFG = dict(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                 max_len=32)
CHAOS_CFG = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                 max_len=64)
# the pinned chaos schedule (tools/chaos_serving.py): r1's replica.kill
# stream first fires at its 6th pump, r2's at 522, the replacement r3's
# at 313
KILL_SPEC, KILL_SEED = "replica.kill:fail@0.005", 138
HTTP_TIMEOUT = 30
JOIN_TIMEOUT = 30

_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny engine ops: one intra-op thread beside the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset():
    for f in (jfault, tfault):
        f.install(None)
    yield
    for f in (jfault, tfault):
        f.install(None)
    tpre.uninstall()
    tpre.reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _model(name):
    """(JAX cfg, JAX params, port cfg, port params) with identical
    weights, built once per module."""
    if name not in _CACHE:
        shape = {"fleet": FLEET_CFG, "chaos": CHAOS_CFG}[name]
        jcfg = jtfm.TransformerConfig(**shape)
        jparams = jtfm.init_params(jcfg, seed=3)
        tparams = ttfm.params_from_numpy(
            {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
        _CACHE[name] = (jcfg, jparams, ttfm.TransformerConfig(**shape),
                        tparams)
    return _CACHE[name]


def _workload(name="fleet", n=4, max_new=8, seed=7):
    """Prompts (as the JAX tests draw them) and their undisturbed JAX
    `generate` references: the oracle every stream is held to."""
    key = (name, n, max_new, seed)
    if key not in _CACHE:
        jcfg, jparams, _, _ = _model(name)
        vocab = jcfg.vocab
        rng = np.random.RandomState(seed)
        hi = 7 if name == "fleet" else 9
        prompts = [rng.randint(1, vocab, size=rng.randint(3, hi))
                   .astype(np.int32) for _ in range(n)]
        refs = [[int(t) for t in np.asarray(
            jtfm.generate(jparams, jnp.asarray(p)[None], max_new, jcfg))[0]]
            for p in prompts]
        _CACHE[key] = (prompts, refs)
    return _CACHE[key]


def _engine(clock=None, slots=2, name="fleet", num_pages=16):
    _, _, cfg, params = _model(name)
    kw = {} if clock is None else {"clock": clock}
    eng = ServingEngine(params, cfg, slots=slots, page_size=8,
                        num_pages=num_pages, device="cpu", **kw)
    eng.warm()
    return eng


def _assert_done_identical(router, ids, refs):
    for i, eid in enumerate(ids):
        r = router.result(eid)
        assert r["state"] == "done", (i, r)
        assert r["tokens"] == refs[i], (i, r["tokens"], refs[i])


def _tick_until(router, clk, pred, n=400, dt=0.01):
    for _ in range(n):
        if pred():
            return True
        router.tick()
        clk.t += dt
    return pred()


def _mid_stream(entry):
    return lambda: 0 < len(entry.tokens) < entry.max_new_tokens


# -- journal semantics ----------------------------------------------------------

def _journal_script(journal_cls):
    """tests/test_serving_fleet.py's epoch-fence script; returns what a
    client and an operator see."""
    events = []
    j = journal_cls(clock=FakeClock())
    e = j.record([1, 2, 3], 8, None, "t0", events.append)
    j.bind(e, "r1", 0)
    seen = [j.on_tokens(e.entry_id, 0, 0, [5, 6]),
            j.on_tokens(e.entry_id, 0, 0, [5]),  # duplicate position
            j.on_tokens(e.entry_id, 0, 2, [7])]
    old_epoch = e.epoch
    j.release(e)  # the epoch bump fences the old assignment out
    seen += [j.on_tokens(e.entry_id, old_epoch, 3, [9, 9]),
             j.on_finish(e.entry_id, old_epoch, "eos"),
             j.on_tokens(e.entry_id, e.epoch, 3, [8])]
    with pytest.raises(RuntimeError, match="journal gap"):
        j.on_tokens(e.entry_id, e.epoch, 10, [1])
    seen.append(j.on_finish(e.entry_id, e.epoch, "length"))
    e2 = j.record([2], 4, None, "t0", events.append)
    j.finish_direct(e2, "length")
    j.finish_direct(e2, "length")  # a second finish is a no-op
    e3 = j.record([3], 4, None, "t0", events.append)
    j.fail(e3, "budget exhausted")
    j.fail(e2, "late")  # failing a finished entry changes nothing
    return (seen, events, j.dup_dropped, j.lost, j.snapshot(),
            j.dump_entries(), e.epoch, old_epoch)


def test_journal_script_equal_jax():
    got, want = _journal_script(RequestJournal), _journal_script(
        JRequestJournal)
    assert got == want
    seen, events, dup, lost, snap, _, epoch, old = got
    assert seen == [2, 0, 1, 0, False, 1, True]
    assert dup == 3 and lost == 1 and epoch == old + 1
    tokens = [ev for ev in events if ev["event"] == "token"]
    assert [ev["index"] for ev in tokens] == [0, 1, 2, 3]
    assert [ev["token"] for ev in tokens] == [5, 6, 7, 8]
    assert [ev["event"] for ev in events].count("done") == 2
    assert snap["states"] == {"done": 2, "failed": 1}


# -- mid-stream failover ------------------------------------------------------

def test_midstream_failover_resumes_token_identical():
    """Kill the replica mid-stream: the journal resume continues the
    greedy decode token-identically to the JAX generate, with zero
    duplicates."""
    prompts, refs = _workload()
    clk = FakeClock()
    router = FleetRouter(clock=clk, heartbeat_timeout=0.5)
    for _ in range(2):
        router.add_replica(_engine(clk))
    streams = {i: [] for i in range(len(prompts))}
    ids = [router.submit(p, 8, tenant=f"t{i % 2}", sink=streams[i].append)
           for i, p in enumerate(prompts)]
    entry = router.journal.get(ids[0])
    assert _tick_until(router, clk, _mid_stream(entry), n=100)
    victim, old_epoch = entry.replica_id, entry.epoch
    router.kill(victim)  # silent: only the heartbeat can notice
    assert _tick_until(router, clk, router.idle, dt=0.05)
    assert router.failovers == 1 and router.resubmits >= 1
    assert entry.resubmits == 1  # the failover consumed budget
    _assert_done_identical(router, ids, refs)
    snap = router.journal.snapshot()
    assert snap["lost"] == 0 and snap["dup_tokens_dropped"] == 0
    for i, ref in enumerate(refs):
        toks = [ev for ev in streams[i] if ev["event"] == "token"]
        assert [ev["index"] for ev in toks] == list(range(len(ref)))
        assert [ev["token"] for ev in toks] == ref
    # a zombie delivery from the dead replica's epoch is fenced out
    before = [list(s) for s in streams.values()]
    assert router.journal.on_tokens(ids[0], old_epoch, 0, [1, 2, 3]) == 0
    assert router.journal.snapshot()["dup_tokens_dropped"] == 3
    assert [list(s) for s in streams.values()] == before


def test_kill_when_decides_under_the_replica_lock():
    """A conditional kill happens only while its predicate holds, seen
    under the replica's lock: a mid-stream request it saw stays
    unfinished until the heartbeat fails it over."""
    prompts, _ = _workload(n=1)
    clk = FakeClock()
    router = FleetRouter(clock=clk, heartbeat_timeout=0.5)
    rep = router.add_replica(_engine(clk))
    eid = router.submit(prompts[0], 8, sink=lambda ev: None)
    entry = router.journal.get(eid)
    assert not router.kill(rep.replica_id, when=lambda: False)
    assert _tick_until(router, clk, _mid_stream(entry), n=100)
    seen = []
    assert router.kill(rep.replica_id,
                       when=lambda: seen.append(len(entry.tokens)) or True)
    assert not router.kill(rep.replica_id)  # already dead
    for _ in range(3):
        router.tick()
    assert len(entry.tokens) == seen[0] < 8 and router.failovers == 0
    clk.t += 1.0
    router.tick()
    assert router.failovers == 1


def test_failover_budget_exhaustion_fails_request():
    prompts, _ = _workload(n=1)
    clk = FakeClock()
    events = []
    router = FleetRouter(clock=clk, heartbeat_timeout=0.5, max_resubmits=0)
    rep = router.add_replica(_engine(clk))
    eid = router.submit(prompts[0], 8, sink=events.append)
    entry = router.journal.get(eid)
    assert _tick_until(router, clk, _mid_stream(entry), n=100)
    router.kill(rep.replica_id)
    clk.t += 1.0
    router.tick()
    assert entry.state == "failed" and router.journal.lost == 1
    assert any(ev["event"] == "failed" for ev in events)
    assert "budget exhausted" in router.result(eid)["error"]
    assert router.idle()  # a failed entry is not stuck work


def test_requeue_finishes_directly_when_stream_already_satisfied():
    clk = FakeClock()
    events = []
    router = FleetRouter(clock=clk, heartbeat_timeout=0.5)
    j = router.journal
    e = j.record([1, 2], 2, None, "t0", events.append)
    j.bind(e, "r9", 0)
    assert j.on_tokens(e.entry_id, 0, 0, [4, 5]) == 2
    with router._lock:
        router._requeue_locked(e, reason="failover")
    assert e.state == "done" and e.finish_reason == "length"
    (done,) = [ev for ev in events if ev["event"] == "done"]
    assert done["tokens"] == [4, 5]
    assert router.tenant_depth("t0") == 0  # never requeued


# -- rolling restart and SIGTERM drain ---------------------------------------

def test_rolling_restart_drops_nothing():
    prompts, refs = _workload()
    clk = FakeClock()
    router = FleetRouter(clock=clk, heartbeat_timeout=30.0)
    old = [router.add_replica(_engine(clk)) for _ in range(2)]
    ids = [router.submit(p, 8) for p in prompts[:2]]
    for _ in range(3):
        router.tick()
        clk.t += 0.01
    for rep in old:
        router.add_replica(_engine(clk))
        router.drain(rep.replica_id)
        ids.append(router.submit(prompts[len(ids)], 8))  # mid-roll arrival
        assert _tick_until(router, clk, lambda: rep.state == "left", n=300)
    assert router.run_until_idle()
    _assert_done_identical(router, ids, refs)
    assert router.drains == 2 and router.failovers == 0


def test_sigterm_drains_fleet_and_stops_admitting():
    prompts, refs = _workload(n=2)
    clk = FakeClock()
    router = FleetRouter(clock=clk, heartbeat_timeout=30.0)
    router.add_replica(_engine(clk))
    ids = [router.submit(p, 8) for p in prompts]
    router.tick()
    tpre.install()
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5
    while not tpre.requested() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert tpre.requested()
    router.tick()  # notices the request and starts the fleet drain
    assert router.draining
    with pytest.raises(RuntimeError, match="draining"):
        router.submit(prompts[0], 8)
    assert router.run_until_idle()
    _assert_done_identical(router, ids, refs)
    assert router.journal.snapshot()["lost"] == 0
    assert all(r.state == "left" for r in router._replicas.values())


def test_replica_rpc_fault_requeues_without_budget():
    prompts, refs = _workload(n=1)
    clk = FakeClock()
    tfault.install(tfault.FaultInjector("replica.rpc:drop@1", seed=0))
    router = FleetRouter(clock=clk, heartbeat_timeout=30.0, max_resubmits=0)
    router.add_replica(_engine(clk))
    eid = router.submit(prompts[0], 8)
    entry = router.journal.get(eid)
    assert router.run_until_idle()
    assert tfault.injector().fired("replica.rpc") == 1
    assert router.resubmits == 1
    assert entry.resubmits == 0  # the rpc retry did not touch the budget
    _assert_done_identical(router, [eid], refs)


# -- gateway ------------------------------------------------------------------

def _post(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", "/v1/generate", body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp, data
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp, resp.read()
    finally:
        conn.close()


def _ndjson(data):
    return [json.loads(ln) for ln in data.split(b"\n") if ln.strip()]


@pytest.fixture
def live_fleet():
    """A started one-replica fleet behind a gateway; closed after."""
    router = FleetRouter(heartbeat_timeout=1.0)
    router.add_replica(_engine())
    router.start(interval=0.001)
    gw = ServingGateway(router, port=0, queue_limit=16, max_occupancy=0.99)
    yield router, gw
    gw.close()
    router.stop()


def test_gateway_stream_unary_healthz_metrics_and_rejections(live_fleet):
    router, gw = live_fleet
    prompts, refs = _workload(n=2, seed=11)
    resp, data = _get(gw.port, "/healthz")
    assert resp.status == 200 and json.loads(data)["healthy_replicas"] == 1
    # a streaming generate: NDJSON tokens, one done, entry id header
    resp, data = _post(gw.port, json.dumps(
        {"prompt": [int(t) for t in prompts[0]], "max_new_tokens": 8}))
    assert resp.status == 200 and resp.getheader("X-Entry-Id") is not None
    events = _ndjson(data)
    toks = [e for e in events if e["event"] == "token"]
    assert [e["token"] for e in toks] == refs[0]
    assert [e["index"] for e in toks] == list(range(len(refs[0])))
    assert sum(e["event"] == "done" for e in events) == 1
    # unary: one JSON body
    resp, data = _post(gw.port, json.dumps(
        {"prompt": [int(t) for t in prompts[1]], "max_new_tokens": 8,
         "stream": False}))
    body = json.loads(data)
    assert resp.status == 200 and body["tokens"] == refs[1]
    assert body["finish_reason"] == "length"
    resp, data = _get(gw.port, "/metrics")
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("text/plain")
    # malformed body -> 400, unknown path -> 404, too long -> 400
    assert _post(gw.port, b"{not json")[0].status == 400
    assert _get(gw.port, "/nope")[0].status == 404
    assert _post(gw.port, json.dumps({"prompt": [1] * 30,
                                      "max_new_tokens": 8}))[0].status == 400
    # a zero-budget gateway sheds with 429 + Retry-After
    gw2 = ServingGateway(router, port=0, queue_limit=0, max_occupancy=0.99)
    try:
        resp, _ = _post(gw2.port, json.dumps({"prompt": [1, 2, 3],
                                              "max_new_tokens": 4}))
        assert resp.status == 429 and resp.getheader("Retry-After") == "1"
    finally:
        gw2.close()
    # and one whose pools are "full" sheds on occupancy
    gw3 = ServingGateway(router, port=0, queue_limit=16, max_occupancy=0.0)
    try:
        resp, data = _post(gw3.port, json.dumps({"prompt": [1, 2, 3],
                                                 "max_new_tokens": 4}))
        assert resp.status == 429 and b"KV page pools" in data
    finally:
        gw3.close()


def test_gateway_listen_backlog_takes_a_burst(live_fleet):
    """socketserver's listen backlog of 5, which the JAX gateway keeps,
    drops the connects of a burst of clients past it; each dropped one
    waits for the kernel's SYN retry a second later. The port's gateway
    listens with a backlog of 128."""
    from incubator_mxnet_tpu.serving import gateway as jgateway
    _, gw = live_fleet
    assert gw._server.request_queue_size == 128
    assert jgateway._GatewayServer.request_queue_size == 5


def test_gateway_accept_fault_and_draining_answer_503(live_fleet):
    router, gw = live_fleet
    tfault.install(tfault.FaultInjector("gateway.accept:fail@1", seed=0))
    resp, _ = _post(gw.port, json.dumps({"prompt": [1, 2],
                                         "max_new_tokens": 2}))
    assert resp.status == 503 and resp.getheader("Retry-After") is not None
    assert tfault.injector().fired("gateway.accept") == 1
    tfault.install(None)
    router.drain_all()
    resp, data = _post(gw.port, json.dumps({"prompt": [1, 2],
                                            "max_new_tokens": 2}))
    assert resp.status == 503 and b"draining" in data
    resp, data = _get(gw.port, "/healthz")
    assert resp.status == 503 and json.loads(data)["status"] == "draining"


def _read_trace_records(directory):
    records = []
    for name in sorted(os.listdir(directory)):
        if name.endswith(".mxtrace"):
            records.extend(tdist.read_trace_file(
                os.path.join(str(directory), name)))
    return records


class _traced:
    """MXTPU_TRACE_DIR (and optional other knobs) set for a block, with
    a fresh trace writer and flight recorder; restored after."""

    def __init__(self, directory, **env):
        self.env = {"MXTPU_TRACE_DIR": str(directory), **env}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        assert tdist.refresh_from_env()
        trec.refresh_from_env()  # a fresh per-process dump budget

    def __exit__(self, *exc):
        tdist.flush()
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tdist.refresh_from_env()


def test_gateway_traceparent_adoption_and_access_log(tmp_path):
    prompts, _ = _workload(n=1, seed=13)
    access_path = os.path.join(str(tmp_path), "access.ndjson")
    tid, psid = "ab" * 8, "cd" * 8
    with _traced(tmp_path, MXTPU_GATEWAY_ACCESS_LOG=access_path):
        router = FleetRouter(heartbeat_timeout=1.0)
        router.add_replica(_engine())
        router.start(interval=0.001)
        gw = ServingGateway(router, port=0, queue_limit=16,
                            max_occupancy=0.99)
        try:
            resp, data = _post(gw.port, json.dumps(
                {"prompt": [int(t) for t in prompts[0]],
                 "max_new_tokens": 4}),
                headers={"traceparent": tdist.format_traceparent(tid, psid)})
            assert resp.status == 200
            assert tdist.parse_traceparent(
                resp.getheader("Traceparent"))[0] == tid
            events = _ndjson(data)
            assert events[0] == {"event": "trace", "trace_id": tid,
                                 "entry_id": events[-1]["entry_id"]}
            assert sum(e["event"] == "done" for e in events) == 1
        finally:
            gw.close()
            router.stop()
        # the handler thread closes the root span right after the last
        # stream write; poll briefly for it to land
        gw_spans = []
        for _ in range(100):
            tdist.flush()
            gw_spans = [r for r in _read_trace_records(tmp_path)
                        if r.get("name") == "gateway.request"]
            if gw_spans:
                break
            time.sleep(0.01)
    (root,) = gw_spans
    assert root["tid"] == tid and root["pid"] == psid
    assert root["lane"] == "gateway"
    assert root["extra"]["status"] == 200 and root["extra"]["outcome"] == "ok"
    with open(access_path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    (gen,) = [ln for ln in lines if ln["path"] == "/v1/generate"]
    assert gen["status"] == 200 and gen["trace_id"] == tid
    assert gen["output_tokens"] == 4 and gen["finish_reason"] == "length"
    assert gen["replica"] is not None


# -- operator view ------------------------------------------------------------

def _tool(name):
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return __import__(name)


def test_debug_snapshot_and_render_fleet():
    prompts, refs = _workload(n=2)
    clk = FakeClock()
    router = FleetRouter(clock=clk, heartbeat_timeout=30.0)
    rep = router.add_replica(_engine(clk))
    ids = [router.submit(p, 8, tenant="acme") for p in prompts]
    for _ in range(3):
        router.tick()
        clk.t += 0.01
    snap = router.debug_snapshot()
    assert snap["schema"] == "mxtpu-serving-fleet-debug-v1"
    rows = {r["replica"]: r for r in snap["replicas"]}
    assert rows[rep.replica_id]["state"] == "healthy"
    assert snap["journal"]["entries"] == 2
    top = _tool("serving_top")
    screen = top.render_fleet(snap)
    assert "serving fleet" in screen and rep.replica_id in screen
    assert "journal 2 entries" in screen and "front queue" in screen
    assert top.render_any(snap) == screen
    assert router.run_until_idle()
    _assert_done_identical(router, ids, refs)


# -- tools/chaos_serving.py's scenarios on the port --------------------------

def _port_ns():
    _, _, cfg, params = _model("chaos")

    def engine(clk=None, slots=3):
        kw = {} if clk is None else {"clock": clk}
        eng = ServingEngine(params, cfg, slots=slots, page_size=8,
                            num_pages=24, device="cpu", **kw)
        eng.warm()
        return eng

    return types.SimpleNamespace(FleetRouter=FleetRouter, fault=tfault,
                                 slo=tslo, engine=engine)


def _jax_ns():
    jcfg, jparams, _, _ = _model("chaos")

    def engine(clk=None, slots=3):
        kw = {} if clk is None else {"clock": clk}
        return JServingEngine(jparams, jcfg, slots=slots, page_size=8,
                              num_pages=24, **kw)

    return types.SimpleNamespace(FleetRouter=JFleetRouter, fault=jfault,
                                 slo=jslo, engine=engine)


def _chaos_failover(ns, lose_one=False, break_chain=False):
    """chaos_serving's failover scenario on one package: the pinned
    replica.kill schedule kills one replica mid-stream, a replacement
    joins. Returns what its gates read."""
    prompts, _ = _workload("chaos", n=8, max_new=12)
    clk = FakeClock()
    ns.fault.install(ns.fault.FaultInjector(KILL_SPEC, seed=KILL_SEED))
    slo = ns.slo.SLOMonitor([ns.slo.Objective("ttft", 10.0),
                             ns.slo.Objective("request_latency", 30.0)],
                            min_samples=4, dump=False)
    router = ns.FleetRouter(clock=clk, heartbeat_timeout=0.4, slo=slo)
    for _ in range(2):
        router.add_replica(ns.engine(clk))
    router._chaos_lose_one = bool(lose_one)
    router._chaos_break_trace = bool(break_chain)
    ids = [router.submit(p, 12, tenant=f"t{i % 3}")
           for i, p in enumerate(prompts)]
    replaced = breached = False
    for _ in range(400):
        if router.idle():
            break
        router.tick()
        clk.t += 0.05
        breached |= any(slo.state(n) == "breach"
                        for n in ("ttft", "request_latency"))
        if not replaced and router.healthy_count() < 2:
            router.add_replica(ns.engine(clk))
            replaced = True
    inj = ns.fault.injector()
    return {"idle": router.idle(), "failovers": router.failovers,
            "resubmits": router.resubmits, "breached": breached,
            "journal": router.journal.snapshot(),
            "results": [router.result(e) for e in ids],
            "kills": inj.fired("replica.kill"),
            "kill_calls": {rid: n for (site, rid), n in inj._calls.items()
                           if site == "replica.kill"},
            "states": {rid: (r.state, r.pumps)
                       for rid, r in router._replicas.items()}}


@pytest.fixture(scope="module")
def jax_chaos_failover():
    out = _chaos_failover(_jax_ns())
    jfault.install(None)
    return out


def test_chaos_failover_pinned_schedule_equal_jax(jax_chaos_failover):
    """The pinned kill schedule fires on the port as on JAX (r1 first, at
    its 6th pump); the port's fleet ends with the JAX fleet's failovers
    and resubmits, lost 0 and dup 0, every stream identical to the JAX
    generate, and the SLO monitor never breaches."""
    got, want = _chaos_failover(_port_ns()), jax_chaos_failover
    _, refs = _workload("chaos", n=8, max_new=12)
    assert got["idle"] and want["idle"]
    for r, ref in zip(got["results"], refs):
        assert r["state"] == "done" and r["tokens"] == ref
    assert [r["tokens"] for r in want["results"]] == refs
    assert got["states"]["r1"] == ("dead", 5)  # killed at its 6th pump
    for key in ("failovers", "resubmits", "journal", "kills",
                "kill_calls", "states"):
        assert got[key] == want[key], key
    assert got["failovers"] == 1 and got["kills"] == 1
    assert got["journal"]["lost"] == 0
    assert got["journal"]["dup_tokens_dropped"] == 0
    assert not got["breached"]


def test_chaos_lost_request_negative_fails_completeness():
    """Seeded negative: the router drops one failover resubmission; the
    zero-lost gate must see it (the fleet never goes idle)."""
    got = _chaos_failover(_port_ns(), lose_one=True)
    assert not got["idle"]
    assert any(r["state"] != "done" for r in got["results"])


def test_chaos_rolling_drops_nothing():
    ns = _port_ns()
    prompts, refs = _workload("chaos", n=8, max_new=12)
    clk = FakeClock()
    router = FleetRouter(clock=clk, heartbeat_timeout=30.0)
    old = [router.add_replica(ns.engine(clk, slots=2)) for _ in range(2)]
    ids = [router.submit(p, 12) for p in prompts[:4]]
    for _ in range(3):
        router.tick()
        clk.t += 0.01
    for rep in old:  # roll the whole fleet, one replica at a time
        router.add_replica(ns.engine(clk, slots=2))
        router.drain(rep.replica_id)
        ids.append(router.submit(prompts[len(ids)], 12))  # mid-roll arrival
        assert _tick_until(router, clk, lambda: rep.state == "left")
    assert _tick_until(router, clk, router.idle)
    _assert_done_identical(router, ids, refs)
    assert router.drains == 2 and router.failovers == 0


def test_chaos_wire_silent_kill_and_backpressure():
    """Threaded fleet behind the HTTP gateway: one replica silently
    killed mid-stream (found by a 1 s real-clock heartbeat), a warmed
    replacement joins the running fleet; every stream completes 200,
    sequential and token-identical, and a queue_limit=0 gateway sheds
    with 429 + Retry-After."""
    ns = _port_ns()
    prompts, refs = _workload("chaos", n=6, max_new=10, seed=11)
    router = FleetRouter(heartbeat_timeout=1.0)
    reps = [router.add_replica(ns.engine()) for _ in range(2)]
    router.start(interval=0.02)
    gw = ServingGateway(router, port=0, queue_limit=64, max_occupancy=0.99)
    out = {}

    def client(i):
        resp, data = _post(gw.port, json.dumps(
            {"prompt": [int(t) for t in prompts[i]], "max_new_tokens": 10,
             "tenant": f"t{i % 2}"}))
        out[i] = (resp.status, _ndjson(data))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not any(
                0 < len(e.tokens) < e.max_new_tokens
                for e in router.journal.assigned_to(reps[0].replica_id)):
            time.sleep(0.002)
        router.kill(reps[0].replica_id)  # silent: heartbeat-only detection
        router.add_replica(ns.engine())  # warmed, joins the running fleet
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT)
            assert not t.is_alive()
        for i, ref in enumerate(refs):
            status, events = out[i]
            assert status == 200
            toks = [e for e in events if e.get("event") == "token"]
            assert [e["index"] for e in toks] == list(range(len(ref)))
            assert [e["token"] for e in toks] == ref
            assert sum(e.get("event") == "done" for e in events) == 1
        assert router.failovers == 1
        gw2 = ServingGateway(router, port=0, queue_limit=0,
                             max_occupancy=0.99)
        try:
            resp, _ = _post(gw2.port, json.dumps({"prompt": [1, 2, 3],
                                                  "max_new_tokens": 4}))
            assert resp.status == 429 and resp.getheader("Retry-After")
        finally:
            gw2.close()
    finally:
        gw.close()
        router.stop()
    assert router.journal.snapshot()["lost"] == 0


# -- fleet observatory: one trace across the whole failover -------------------

def _traced_failover(directory, break_chain=False):
    with _traced(directory):
        got = _chaos_failover(_port_ns(), break_chain=break_chain)
    _, refs = _workload("chaos", n=8, max_new=12)
    # tracing (or a broken chain) never disturbs the decode
    assert got["idle"] and got["failovers"] == 1
    assert [r["tokens"] for r in got["results"]] == refs
    return got, _read_trace_records(directory)


def _check_fleet(records):
    merge = _tool("trace_merge")
    deliveries = [r for r in records if r.get("kind") == "fleet_delivery"]
    return merge.check_fleet([r for r in records if r.get("kind") is None],
                             deliveries)


def test_traced_failover_passes_check_fleet(tmp_path):
    got, records = _traced_failover(tmp_path)
    spans = [r for r in records if "kind" not in r]
    fos = [r for r in spans if r["name"] == "fleet.failover"]
    victim = next(rid for rid, (state, _) in got["states"].items()
                  if state == "dead")
    assert fos and all(fo["extra"]["victim"] == victim
                       and fo["extra"]["cause"] == "heartbeat_timeout"
                       and fo["extra"]["survivor"] not in (None, victim)
                       for fo in fos)
    resubs = [r for r in spans if r["name"] == "fleet.resubmit"
              and r["extra"]["reason"] == "failover"]
    assert len(resubs) == len(fos)
    disp = {r["sid"]: r for r in spans if r["name"] == "fleet.dispatch"}
    roots = [r for r in spans if r["name"] == "serving.request"]
    assert roots and all(disp[r["pid"]]["tid"] == r["tid"] for r in roots)
    assert _check_fleet(records) == []
    # the JAX tool reads the port's files and gates green
    assert _tool("trace_merge").main([str(tmp_path), "--fleet",
                                      "--check"]) == 0
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("flightrec-") and "fleet-failover" in f]
    (dump,) = dumps
    with open(os.path.join(str(tmp_path), dump)) as f:
        fleet = json.load(f)["fleet"]
    assert fleet["victim"] == victim and fleet["journal"]["entries"] == 8
    assert set(fleet["replica_timelines"]) == {"r1", "r2"}


def test_traced_broken_chain_fails_check_fleet(tmp_path):
    """The serving gates pass (the corruption is observability-only),
    the fleet check must not."""
    _, records = _traced_failover(tmp_path, break_chain=True)
    problems = _check_fleet(records)
    assert any("orphaned" in p for p in problems)
    assert _tool("trace_merge").main([str(tmp_path), "--fleet",
                                      "--check"]) == 2
