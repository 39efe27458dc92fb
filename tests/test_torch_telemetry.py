"""The port's telemetry modules against the JAX package's on the same
inputs: the name registry, the capture registry (the JAX compile
registry's API), the SLO monitor, the exporters, the MXTRACE1 trace files,
W3C traceparent, the flight recorder and spans."""
import dataclasses
import json
import os
import urllib.request

import numpy as np
import pytest

from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu.telemetry import compilereg as jreg
from incubator_mxnet_tpu.telemetry import distributed as jdist
from incubator_mxnet_tpu.telemetry import recorder as jrec
from incubator_mxnet_tpu.telemetry import slo as jslo
from incubator_mxnet_tpu_torch import graphs, profiler
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.telemetry import compilereg as treg
from incubator_mxnet_tpu_torch.telemetry import distributed as tdist
from incubator_mxnet_tpu_torch.telemetry import recorder as trec
from incubator_mxnet_tpu_torch.telemetry import slo as tslo

PACKAGES = {"jax": (jtel, jreg, jdist, jrec, jslo),
            "torch": (ttel, treg, tdist, trec, tslo)}


@pytest.fixture
def both_on(monkeypatch):
    """Telemetry on in both packages, registries and capture registries
    empty; everything back to the environment's state afterwards."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    for tel, reg, *_ in PACKAGES.values():
        tel.refresh_from_env()
        tel.REGISTRY.reset()
        reg.reset()
    yield
    monkeypatch.delenv("MXNET_TELEMETRY")
    for tel, reg, *_ in PACKAGES.values():
        tel.refresh_from_env()
        tel.REGISTRY.reset()
        reg.reset()


@pytest.fixture
def traced(tmp_path, monkeypatch):
    """MXTPU_TRACE_DIR (and the flight-recorder dump dir) set for both
    packages' tracing and recorders."""
    d = str(tmp_path / "traces")
    monkeypatch.setenv("MXTPU_TRACE_DIR", d)
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_DIR", d)
    for _, _, dist, rec, *_ in PACKAGES.values():
        dist.refresh_from_env()
        rec.refresh_from_env()
    yield d
    monkeypatch.delenv("MXTPU_TRACE_DIR")
    monkeypatch.delenv("MXTPU_FLIGHT_RECORDER_DIR")
    for _, _, dist, rec, *_ in PACKAGES.values():
        dist.refresh_from_env()
        rec.refresh_from_env()


def _no_ts(snapshot):
    return {fn: {**v, "entries": [{k: x for k, x in e.items()
                                   if k != "ts_ns"} for e in v["entries"]]}
            for fn, v in snapshot.items()}


def test_names_equal_the_jax_registry():
    assert ttel.METRIC_NAMES == jtel.METRIC_NAMES
    assert ttel.SPAN_NAMES == jtel.SPAN_NAMES
    for name in ("mxtpu_compiles_total", "mxtpu_retraces_total",
                 "mxtpu_compile_seconds",
                 "mxtpu_decode_dense_fallbacks_total"):
        assert ttel.is_registered_metric(name)
    assert ttel.is_registered_span("serving.request.decode")


def test_capture_registry_equals_the_compile_registry(both_on):
    """The same register sequence gives the same return values, snapshot
    (timestamps aside), counters and flight events in both registries."""
    a = np.zeros((3, 8), np.int64)
    b = np.zeros((3, 16), np.int32)
    spec = {"w": np.zeros((2, 2), np.float32), "n": 3}
    steps = [("register", "f", (a, spec), {"compile_s": 0.5}),
             ("register", "f", (a, spec), {}),
             ("register", "f", (b, None), {"compile_s": 1.25}),
             ("seen", "f", (b, None), {}),
             ("seen", "g", (a,), {}),
             ("register_cached", "g", (a,), {}),
             ("register", "g", (a,), {}),
             ("annotate", "f", None, {"compile_s": 2.0,
                                      "cost": {"flops": 3}}),
             ("register", "h", (np.float32, 7, "x"), {"graph_hash": "abc"})]
    got = {}
    for pkg, (tel, reg, _, rec, *_) in PACKAGES.items():
        out = []
        for op, fn, args, kw in steps:
            sig = reg.signature_of(*args) if args is not None else None
            call = getattr(reg, op)
            out.append(call(fn, sig, **kw) if op != "annotate"
                       else call(fn, **kw))
        events = [{k: v for k, v in e.items() if k not in ("ts", "lane")}
                  for e in rec.snapshot()
                  if e["kind"] in ("compile", "retrace",
                                   "compile_cache_hit")][-4:]
        got[pkg] = (out, _no_ts(reg.snapshot()), tel.to_dict(), events)
    assert got["torch"][0] == ["new", "seen", "retrace", True, False,
                               "cached", "seen", True, "new"]
    assert got["torch"] == got["jax"]


def test_capture_registry_is_silent_while_telemetry_is_off():
    assert not ttel.enabled()
    sig = treg.signature_of(np.zeros(3))
    assert treg.register("off_fn", sig) is None
    assert treg.seen("off_fn", sig) is True
    assert "off_fn" not in treg.snapshot()


# SLO monitor settings: short windows with a re-arming breach, the knobs'
# defaults over a long run, and a window of one sample with a high floor
SLO_CASES = {
    "short": dict(windows=(4, 8), min_samples=4, burns=(1.0, 3.0),
                  budgets=(0.1, 0.25), n=60, bad_rate=0.1),
    "defaults": dict(windows=(32, 128), min_samples=8, burns=(1.0, 10.0),
                     budgets=(0.01, 0.01), n=300, bad_rate=0.02),
    "single": dict(windows=(1, 1), min_samples=1, burns=(0.5, 2.0),
                   budgets=(0.5, 0.5), n=40, bad_rate=0.3),
}


def _slo_run(slo_mod, case):
    mon = slo_mod.SLOMonitor(
        [slo_mod.Objective("ttft", 0.5, budget=case["budgets"][0]),
         slo_mod.Objective("goodput", 0.8, kind="floor",
                           budget=case["budgets"][1])],
        window_short=case["windows"][0], window_long=case["windows"][1],
        min_samples=case["min_samples"], warn_burn=case["burns"][0],
        breach_burn=case["burns"][1], dump=False)
    rng = np.random.RandomState(7)
    states = []
    for i in range(case["n"]):
        bad = ((case["n"] // 6 <= i < case["n"] // 3)
               or (case["n"] // 2 <= i < 3 * case["n"] // 5)
               or rng.rand() < case["bad_rate"])
        states.append(mon.observe_request(
            ttft=2.0 if bad else 0.1 * rng.rand(),
            goodput=0.5 if bad and i % 2 else 0.95,
            queue_wait=1.0))
        states.append((mon.state("ttft"), mon.state("goodput")))
    return states, mon.snapshot()


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_monitor_equals_jax(case, both_on):
    """The same samples give the same states after every request, the
    same snapshot and the same burn-rate gauges."""
    jstates, jsnap = _slo_run(jslo, SLO_CASES[case])
    tstates, tsnap = _slo_run(tslo, SLO_CASES[case])
    assert tstates == jstates
    assert tsnap == jsnap
    assert tsnap["ttft"]["breaches"] >= 2  # the episode re-armed
    seen = {s for pair in tstates if pair for s in pair}
    # one sample a window jumps from ok to breach with no warning between
    assert seen == ({"ok", "breach"} if case == "single"
                    else {"ok", "warning", "breach"})
    assert ttel.to_dict() == jtel.to_dict()


def test_slo_from_env_equals_jax(monkeypatch):
    for pkg in PACKAGES.values():
        assert pkg[4].from_env() is None
    monkeypatch.setenv("MXTPU_SLO_TTFT_P99", "0.25")
    monkeypatch.setenv("MXTPU_SLO_GOODPUT_MIN", "0.5")
    monkeypatch.setenv("MXTPU_SLO_WINDOW_SHORT", "3")
    monkeypatch.setenv("MXTPU_SLO_WINDOW_LONG", "6")
    jmon, tmon = jslo.from_env(), tslo.from_env()
    assert ([dataclasses.astuple(o) for o in tmon.objectives]
            == [dataclasses.astuple(o) for o in jmon.objectives]
            == [("ttft", 0.25, "ceiling", 0.01),
                ("goodput", 0.5, "floor", 0.01)])
    assert (tmon.window_short, tmon.window_long, tmon.min_samples,
            tmon.warn_burn, tmon.breach_burn) == (
        jmon.window_short, jmon.window_long, jmon.min_samples,
        jmon.warn_burn, jmon.breach_burn) == (3, 6, 8, 1.0, 10.0)


def _fill(tel):
    reg = tel.REGISTRY
    c = reg.counter("mxtpu_serving_tokens_total", "tokens")
    c.inc(5, kind="prefill")
    c.inc(2.5, kind="decode")
    c.inc(1e16, kind="pad")
    reg.gauge("mxtpu_serving_goodput", 'a "quoted"\nhelp').set(0.123456789)
    reg.gauge("mxtpu_serving_queue_depth").set(3, replica='r"0\\')
    h = reg.histogram("mxtpu_serving_ttft_seconds", "ttft",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.004, 0.004, 0.05, 0.3, 2.0, 7.5):
        h.observe(v, route="a")
    h.observe(0.02, route="b")
    reg.histogram("mxtpu_span_seconds").observe(0.002, span="serving.step")
    reg.histogram("mxtpu_compile_seconds", buckets=(1.0, 10.0))


def test_prometheus_text_and_json_equal_jax(both_on, tmp_path):
    for tel, *_ in PACKAGES.values():
        _fill(tel)
    assert ttel.prometheus_text() == jtel.prometheus_text()
    assert ttel.to_dict() == jtel.to_dict()
    tpath, jpath = tmp_path / "t.json", tmp_path / "j.json"
    ttel.dump_json(str(tpath))
    jtel.dump_json(str(jpath))
    assert tpath.read_text() == jpath.read_text()
    text = ttel.prometheus_text()
    assert 'mxtpu_serving_ttft_seconds{route="a",quantile="0.5"}' in text


def test_metrics_endpoint_serves_the_exposition(both_on):
    _fill(ttel)
    srv = ttel.start_http_server(0, host="127.0.0.1")
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics") as resp:
            body = resp.read().decode()
            kind = resp.headers["Content-Type"]
    finally:
        srv.close()
    assert kind == "text/plain; version=0.0.4"
    assert body == ttel.prometheus_text()


@pytest.mark.parametrize("header", [
    None, "", "garbage", "00-" + "0" * 32 + "-" + "ab" * 8 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "00-0000000000000000a1b2c3d4e5f60718-0123456789abcdef-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00 ",
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"])
def test_traceparent_round_trips_as_jax(header):
    got = tdist.parse_traceparent(header)
    assert got == jdist.parse_traceparent(header)
    if got is not None:
        tid, sid = got
        text = tdist.format_traceparent(tid, sid)
        assert text == jdist.format_traceparent(tid, sid)
        assert tdist.parse_traceparent(text) == got
    mine = (tdist.new_id(), tdist.new_id())
    assert tdist.parse_traceparent(tdist.format_traceparent(*mine)) == mine


def test_lanes_and_remote_context_as_jax(monkeypatch):
    """The per-process lane from MXTPU_PROCESS_ID, a thread's override and
    a peer's context adopted for a block, restored after it, in both."""
    monkeypatch.setenv("MXTPU_PROCESS_ID", "3")
    got = {}
    try:
        for pkg, dist in (("jax", jdist), ("torch", tdist)):
            dist.refresh_from_env()  # forgets the cached process lane
            seq = [dist.current_lane()]
            prev = dist.set_thread_lane("w1")
            seq += [prev, dist.current_lane()]
            with dist.remote_context(("t1", "s1"), lane="server"):
                seq += [dist.current_lane(), dist.remote_parent()]
            seq += [dist.current_lane(), dist.remote_parent()]
            dist.set_thread_lane(prev)
            seq.append(dist.current_lane())
            with dist.remote_context(None):
                seq.append(dist.remote_parent())
            got[pkg] = seq
    finally:
        monkeypatch.delenv("MXTPU_PROCESS_ID")
        for dist in (jdist, tdist):
            dist.refresh_from_env()
    assert got["torch"] == got["jax"] == [
        "r3", None, "w1", "server", ("t1", "s1"), "w1", None, "r3", None]


def _records(n):
    return [{"name": "serving.request", "tid": f"{i:016x}",
             "sid": f"{i + 100:016x}", "ts": 1_000_000 + i, "dur_ns": 7 * i,
             "extra": {"request": i, "finish": "length", "txt": "é\n"},
             "lane": "r0", "thr": 1} for i in range(n)]


def test_trace_files_are_byte_identical_and_cross_readable(tmp_path):
    """The same records through both writers give the same bytes, and a
    file of either package reads back through the other's reader."""
    paths = {}
    for pkg, (_, _, dist, *_) in PACKAGES.items():
        w = dist._TraceWriter(str(tmp_path / pkg), buffer_spans=3)
        for rec in _records(7):
            w.add(rec)
        w.close()
        paths[pkg] = w.path
    data = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    assert data["torch"] == data["jax"]
    assert data["torch"].startswith(b"MXTRACE1")
    assert jdist.read_trace_file(paths["torch"]) == _records(7)
    assert tdist.read_trace_file(paths["jax"]) == _records(7)
    # a torn tail frame: everything before it survives, in both readers
    torn = tmp_path / "torn.mxtrace"
    torn.write_bytes(data["torch"][:-5])
    assert (tdist.read_trace_file(str(torn))
            == jdist.read_trace_file(str(torn)) == _records(6))
    bad = tmp_path / "bad.mxtrace"
    bad.write_bytes(b"NOTATRACE")
    with pytest.raises(ValueError, match="bad magic"):
        tdist.read_trace_file(str(bad))


def test_spans_nest_into_one_trace_read_by_jax(traced, both_on):
    with ttel.span("serving.step", step=3) as outer:
        with ttel.span("serving.prefill", request=1) as inner:
            inner.annotate(bucket=16).bump("retries")
            assert ttel.current_span() is inner
        with pytest.raises(KeyError):
            with ttel.span("serving.prefill_chunk", slots=2):
                raise KeyError("x")
    assert ttel.current_span() is None
    tdist.flush()
    files = [os.path.join(traced, f) for f in os.listdir(traced)
             if f.endswith(".mxtrace")]
    recs = {r["name"]: r for f in files for r in jdist.read_trace_file(f)}
    root = recs["serving.step"]
    assert root["sid"] == outer.span_id and root["pid"] is None
    for name in ("serving.prefill", "serving.prefill_chunk"):
        assert recs[name]["tid"] == root["tid"]
        assert recs[name]["pid"] == root["sid"]
    assert recs["serving.prefill"]["extra"] == {"bucket": 16, "retries": 1}
    assert recs["serving.prefill_chunk"]["tags"]["error"] == "KeyError"
    assert recs["serving.step"]["tags"] == {"step": "3"}
    errors = ttel.REGISTRY.counter("mxtpu_span_errors_total")
    assert errors.value(name="serving.prefill_chunk") == 1.0
    hist = ttel.REGISTRY.histogram("mxtpu_span_seconds")
    assert {lab["span"] for lab, _ in hist.series()} == {
        "serving.step", "serving.prefill", "serving.prefill_chunk"}
    # a peer's context adopted: a root span joins the remote trace
    with tdist.remote_context(("feedface00000001", "feedface00000002"),
                              lane="peer"):
        with ttel.span("fleet.dispatch") as sp:
            assert (sp.trace_id, sp.parent_id) == ("feedface00000001",
                                                   "feedface00000002")
            assert tdist.current_context() == (sp.trace_id, sp.span_id)


def test_spans_cost_nothing_while_off():
    assert not ttel.enabled() and not tdist.trace_active()
    assert ttel.span("serving.step", step=1) is ttel.NOOP_SPAN
    with ttel.span("serving.step") as sp:
        assert sp.annotate(x=1) is sp and ttel.current_span() is None


def test_span_annotates_the_profiler_window(both_on):
    """While a window is marked running, a span opens a record_function
    range of its name; while none is, it opens none."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttel.span("serving.step", step=0):
            torch.ones(4).sum()
    assert "serving.step" not in {e.name for e in prof.events()}
    profiler.set_state("run")
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with ttel.span("serving.step", step=0):
                torch.ones(4).sum()
    finally:
        profiler.set_state("stop")
    assert "serving.step" in {e.name for e in prof.events()}
    with pytest.raises(ValueError):
        profiler.set_state("pause")


def test_recorder_ring_wraps_as_jax():
    for cap, n in ((4, 10), (5, 3), (1, 2)):
        rings = [pkg[3].FlightRecorder(cap) for pkg in PACKAGES.values()]
        for ring in rings:
            for i in range(n):
                ring.record({"kind": "e", "i": i})
        j, t = rings
        assert t.snapshot() == j.snapshot() == [
            {"kind": "e", "i": i} for i in range(max(0, n - cap), n)]
        assert t.total_recorded() == j.total_recorded() == n


def test_recorder_dumps_ring_metrics_and_knobs(both_on, tmp_path,
                                               monkeypatch):
    """The dump holds the ring, the metrics and the knobs. The knobs are
    set for the port's recorder alone and its ring is rebuilt from the
    restored environment afterwards: a ring resolved while they are set
    would keep a capacity of 3 for the rest of the process."""
    knobs = {"MXTPU_FLIGHT_RECORDER_DIR": str(tmp_path / "dumps"),
             "MXTPU_FLIGHT_RECORDER_EVENTS": "3",
             "MXTPU_FLIGHT_RECORDER_MAX_DUMPS": "1"}
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)
    trec.refresh_from_env()
    try:
        for i in range(5):
            ev = trec.log_event("probe", i=i)
        assert ev["kind"] == "probe" and ev["lane"] == tdist.current_lane()
        ttel.inc("mxtpu_serving_requests_total", outcome="eos")
        path = trec.dump("slo breach/ttft",
                         extra={"request_timelines": [1],
                                "reason": "not mine"})
        assert os.path.basename(path).startswith(
            f"flightrec-{os.getpid()}-1-slo-breach-ttft")
        payload = json.load(open(path))
        assert payload["schema"] == "mxtpu-flight-recorder-v1"
        assert payload["reason"] == "slo breach/ttft"  # core keys win
        assert payload["request_timelines"] == [1]
        assert [e["i"] for e in payload["events"]] == [2, 3, 4]
        assert payload["events_recorded_total"] == 5
        assert payload["metrics"]["metrics"][
            "mxtpu_serving_requests_total"]["series"][0]["value"] == 1.0
        assert payload["config"]["MXTPU_FLIGHT_RECORDER_EVENTS"] == 3
        assert trec.dump("again") is None  # the per-process cap is spent
        dumps = ttel.REGISTRY.counter("mxtpu_flight_recorder_dumps_total")
        assert dumps.value(reason="slo-breach-ttft") == 1.0
    finally:
        for name in knobs:
            monkeypatch.delenv(name)
        trec.refresh_from_env()
    assert trec._get_ring().capacity == 4096  # the default again


def test_site_on_cpu_registers_its_first_call(both_on):
    calls = []

    def fn(x, y):
        calls.append(1)
        return x + y

    site = graphs.wrap("serving_probe", fn, device="cpu")
    a, b = np.arange(3), np.ones(3, np.int64)
    assert site(a, b).tolist() == [1, 2, 3]
    assert site(a, b).tolist() == [1, 2, 3]
    assert site.warm((3,), (3,)) == "memo"
    assert site.warm((5,), (5,)) == "eager"
    snap = treg.snapshot()["serving_probe"]
    assert (snap["signatures"], snap["retraces"]) == (2, 1)
    assert [e["signature"] for e in snap["entries"]] == [
        str(treg.signature_of(np.zeros(n, np.int64), np.zeros(n, np.int64)))
        for n in (3, 5)]
    assert site.replays == 0 and len(calls) == 3


def test_failed_capture_raises_and_never_runs_eagerly():
    """A site on a CUDA device whose capture cannot happen (here: no CUDA
    at all) raises, naming the site; `fn` never runs in its place."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this capture would succeed")
    calls = []
    site = graphs.wrap("serving_probe", lambda x: calls.append(x),
                       device="cuda")
    for call in (lambda: site(np.zeros(2, np.int64)),
                 lambda: site.warm((2,))):
        with pytest.raises(RuntimeError,
                           match="capture of site 'serving_probe' failed"):
            call()
    assert not calls
