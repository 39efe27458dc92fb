"""The port's serving observability on the CPU, beside the JAX engine's
(`tests/test_serving_observability.py`): request traces, SLOs and breach
dumps, `/debug/engine`, `warm()` and the capture registry's counters."""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu.models import transformer as jtfm
from incubator_mxnet_tpu.serving import ServingEngine as JaxEngine
from incubator_mxnet_tpu.telemetry import compilereg as jreg
from incubator_mxnet_tpu.telemetry import slo as jslo
from incubator_mxnet_tpu_torch import telemetry
from incubator_mxnet_tpu_torch.models import transformer as tfm
from incubator_mxnet_tpu_torch.serving import ServingEngine, run_trace
from incubator_mxnet_tpu_torch.telemetry import compilereg
from incubator_mxnet_tpu_torch.telemetry import distributed as _distributed
from incubator_mxnet_tpu_torch.telemetry import exporters as _exporters
from incubator_mxnet_tpu_torch.telemetry import recorder as _recorder
from incubator_mxnet_tpu_torch.telemetry import slo as _slo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
            max_len=32)
SMALL = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_len=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = tfm.TransformerConfig(**TINY)
    return cfg, tfm.init_params(cfg, seed=0, device="cpu")


def _engine(tiny, **kw):
    cfg, params = tiny
    base = dict(slots=2, page_size=8, num_pages=16, device="cpu")
    base.update(kw)
    return ServingEngine(params, cfg, **base)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 32, n).astype(np.int32)


@pytest.fixture
def traced(tmp_path, monkeypatch):
    d = str(tmp_path / "traces")
    monkeypatch.setenv("MXTPU_TRACE_DIR", d)
    monkeypatch.setenv("MXTPU_FLIGHT_RECORDER_DIR", d)
    _distributed.refresh_from_env()
    _recorder.refresh_from_env()
    yield d
    monkeypatch.delenv("MXTPU_TRACE_DIR")
    monkeypatch.delenv("MXTPU_FLIGHT_RECORDER_DIR")
    _distributed.refresh_from_env()
    _recorder.refresh_from_env()


@pytest.fixture
def metrics_on(monkeypatch):
    """Telemetry on in both packages (the capture and compile registries
    count only then), registries empty before and after."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    for tel, reg in ((telemetry, compilereg), (jtel, jreg)):
        tel.refresh_from_env()
        tel.REGISTRY.reset()
        reg.reset()
    yield
    monkeypatch.delenv("MXNET_TELEMETRY")
    for tel, reg in ((telemetry, compilereg), (jtel, jreg)):
        tel.refresh_from_env()
        tel.REGISTRY.reset()
        reg.reset()


def _load_records(trace_dir):
    _distributed.flush()
    return [rec for name in sorted(os.listdir(trace_dir))
            if name.endswith(".mxtrace")
            for rec in _distributed.read_trace_file(
                os.path.join(trace_dir, name))]


def _serving_top():
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import serving_top
    return serving_top


# -- per-request lifecycle tracing -------------------------------------------

def test_request_trace_causal_chain(tiny, traced):
    eng = _engine(tiny)
    r0 = eng.submit(_prompt(5), 4)
    r1 = eng.submit(_prompt(9, seed=1), 6, eos_id=0)
    r2 = eng.submit(_prompt(3, seed=2), 2,
                    trace_ctx=("feedface00000001", "feedface00000002"))
    results = eng.run()
    records = _load_records(traced)

    roots = {r["extra"]["request"]: r for r in records
             if r.get("name") == "serving.request"}
    assert set(roots) == {r0, r1, r2}
    # an inbound context: the request joins that trace under that span
    assert roots[r2]["tid"] == "feedface00000001"
    assert roots[r2]["pid"] == "feedface00000002"
    steps = [r for r in records if r.get("kind") == "req_step"]
    for rid in (r0, r1, r2):
        root, res = roots[rid], results[rid]
        stages = {r["name"]: r for r in records
                  if r.get("name", "").startswith("serving.request.")
                  and r["extra"].get("request") == rid}
        assert {"serving.request.queued",
                "serving.request.prefill"} <= set(stages)
        if len(res.tokens) > 1:
            assert "serving.request.decode" in stages
        for stage in stages.values():
            assert stage["tid"] == root["tid"]
            assert stage["pid"] == root["sid"]
            assert stage["ts"] >= root["ts"]
        extra = root["extra"]
        assert extra["finish"] == res.finish_reason
        assert extra["tokens"] == len(res.tokens)
        assert extra["prompt_len"] == res.prompt_len
        assert extra["latency_s"] == res.latency_s
        assert extra["queue_wait_s"] == res.queue_wait_s
        assert 0.0 < extra["ttft_s"] <= extra["latency_s"]
        progressed = sum(1 for r in steps
                         for slot in r["slots"] if slot[0] == rid)
        assert progressed == extra["decode_steps"] == len(res.tokens) - 1
    assert len(steps) <= eng.steps
    # the step spans ride the same file, one per scheduler iteration
    assert sum(r.get("name") == "serving.step" for r in records) == eng.steps


def _shape(records):
    """A trace's records without their ids and clock readings: names,
    extras, each stage's parent as the index of its root, req_step
    progress."""
    roots = {r["sid"]: i for i, r in enumerate(records)
             if r.get("name") == "serving.request"}
    out = []
    for r in records:
        if r.get("kind") == "req_step":
            out.append(("req_step", r["step"], r["slots"]))
        else:
            out.append((r["name"], r.get("extra"), roots.get(r.get("pid")),
                        r.get("tags")))
    return out


@pytest.mark.parametrize("leg", ["off", "prefix", "chunked", "spec"])
def test_request_records_equal_the_jax_engines(leg, tiny, tmp_path,
                                               monkeypatch):
    """The same requests, weights, levers and (frozen) clock through both
    engines with tracing on: the port's trace holds the JAX engine's
    records in the JAX engine's order, names, extras, parent links and
    step records alike (ids and wall-clock stamps aside)."""
    from incubator_mxnet_tpu.telemetry import distributed as jdist

    levers = {"off": {}, "prefix": dict(prefix_cache=1),
              "chunked": dict(prefill_chunk=4),
              "spec": dict(spec_ngram=1, spec_lookahead=2)}[leg]
    jcfg = jtfm.TransformerConfig(**TINY)
    first = _prompt(11)
    second = np.concatenate([first[:9], _prompt(3, seed=1)])
    shapes = {}
    for pkg, dist, make in (
            ("torch", _distributed,
             lambda: _engine(tiny, slots=1, clock=lambda: 0.0, **levers)),
            ("jax", jdist,
             lambda: JaxEngine(jtfm.init_params(jcfg, seed=0), jcfg,
                               slots=1, page_size=8, num_pages=16,
                               clock=lambda: 0.0, **levers))):
        d = str(tmp_path / pkg)
        monkeypatch.setenv("MXTPU_TRACE_DIR", d)
        dist.refresh_from_env()
        try:
            eng = make()
            eng.submit(first, 6)
            eng.submit(second, 3, trace_ctx=("feedface00000001", None))
            rid = eng.submit(_prompt(4, seed=2), 2)
            eng.step()
            eng.cancel(rid)
            eng.run()
            dist.flush()
            shapes[pkg] = _shape([r for f in sorted(os.listdir(d))
                                  for r in dist.read_trace_file(
                                      os.path.join(d, f))])
        finally:
            monkeypatch.delenv("MXTPU_TRACE_DIR")
            dist.refresh_from_env()
    assert len(shapes["torch"]) > 8
    assert shapes["torch"] == shapes["jax"]


def test_zero_trace_records_when_off(tiny, monkeypatch):
    assert not _distributed.trace_active()
    eng = _engine(tiny)
    emitted = []
    monkeypatch.setattr(_distributed, "record_span", emitted.append)
    rid = eng.submit(_prompt(4), 3)
    eng.run()
    assert eng.results()[rid].tokens
    assert not emitted, "engine emitted trace records with tracing off"


def test_trace_merge_requests_check_passes_over_the_ports_trace(
        tiny, traced, tmp_path):
    """tools/trace_merge.py (it imports the JAX package, so it runs here
    in a subprocess on the CPU) merges the port's files and its
    --requests --check passes, each row equal to the engine's result."""
    eng = _engine(tiny)
    rids = [eng.submit(_prompt(4 + i, seed=i), 3 + i) for i in range(3)]
    rid_c = eng.submit(_prompt(6, seed=9), 4)
    eng.cancel(rid_c)
    results = eng.run()
    _distributed.flush()
    timeline = str(tmp_path / "timeline.json")
    report = str(tmp_path / "requests.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_merge.py"),
         traced, "-o", timeline, "--requests", "--requests-json", report,
         "--check"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.load(open(report))
    assert rep["count"] == len(rids) + 1
    by_rid = {row["request"]: row for row in rep["requests"]}
    for rid in rids:
        row, res = by_rid[rid], results[rid]
        assert row["finish"] == res.finish_reason
        assert row["tokens"] == len(res.tokens)
        assert row["ttft_s"] <= row["latency_s"]
        assert row["progress_steps"] == row["decode_steps"]
    assert by_rid[rid_c]["finish"] == "cancelled"
    lanes = {e["args"]["name"] for e in json.load(open(timeline))[
        "traceEvents"] if e["ph"] == "M" and e["name"] == "process_name"}
    assert {f"req{rid}" for rid in rids} <= lanes


# -- SLOs --------------------------------------------------------------------

def test_breach_fires_exactly_one_dump(traced):
    timelines = [{"request_id": 1, "latency_s": 2.0}]
    mon = _slo.SLOMonitor(
        [_slo.Objective("ttft", 0.5, budget=0.1)],
        window_short=4, window_long=4, min_samples=4,
        warn_burn=1.0, breach_burn=5.0, timelines=lambda: timelines)
    for _ in range(8):
        mon.observe("ttft", 2.0)
    dumps = [f for f in os.listdir(traced) if f.startswith("flightrec-")]
    assert len(dumps) == 1, f"expected exactly one dump, got {dumps}"
    payload = json.load(open(os.path.join(traced, dumps[0])))
    assert payload["reason"] == "slo-breach-ttft"
    assert payload["request_timelines"] == timelines
    assert payload["slo"]["ttft"]["state"] == "breach"
    for _ in range(8):
        mon.observe("ttft", 0.1)
    for _ in range(8):
        mon.observe("ttft", 2.0)
    assert len([f for f in os.listdir(traced)
                if f.startswith("flightrec-")]) == 2


def test_slo_from_env(monkeypatch):
    assert _slo.from_env() is None
    monkeypatch.setenv("MXTPU_SLO_TTFT_P99", "0.25")
    monkeypatch.setenv("MXTPU_SLO_GOODPUT_MIN", "0.5")
    monkeypatch.setenv("MXTPU_SLO_WINDOW_SHORT", "3")
    monkeypatch.setenv("MXTPU_SLO_WINDOW_LONG", "6")
    mon = _slo.from_env()
    names = {o.name: o for o in mon.objectives}
    assert set(names) == {"ttft", "goodput"}
    assert names["ttft"].kind == "ceiling"
    assert names["goodput"].kind == "floor"
    assert mon.window_short == 3 and mon.window_long == 6
    mon.observe_request(ttft=0.1, queue_wait=9.9, request_latency=9.9,
                        goodput=0.9)
    assert mon.snapshot()["ttft"]["samples"] == 1


def test_engine_attaches_slo_from_env_and_breaches(tiny, traced,
                                                   monkeypatch):
    monkeypatch.setenv("MXTPU_SLO_TTFT_P99", "1e-12")  # everything is bad
    monkeypatch.setenv("MXTPU_SLO_WINDOW_SHORT", "2")
    monkeypatch.setenv("MXTPU_SLO_WINDOW_LONG", "4")
    monkeypatch.setenv("MXTPU_SLO_MIN_SAMPLES", "2")
    eng = _engine(tiny)
    assert eng.slo is not None
    assert _engine(tiny, slo=False).slo is None
    for i in range(4):
        eng.submit(_prompt(4, seed=i), 3)
    eng.run()
    assert eng.slo.state("ttft") == "breach"
    assert eng.debug_snapshot()["slo"]["ttft"]["breaches"] == 1
    dumps = [f for f in os.listdir(traced) if f.startswith("flightrec-")
             and "slo-breach-ttft" in f]
    assert len(dumps) == 1
    payload = json.load(open(os.path.join(traced, dumps[0])))
    assert {t["request_id"] for t in payload["request_timelines"]} <= \
        set(eng.results())
    assert {"prompt_len", "tokens", "finish", "ttft_s",
            "latency_s"} <= set(payload["request_timelines"][0])
    assert any(e["kind"] == "serving_request_finish"
               for e in payload["events"])


# -- /debug/engine ------------------------------------------------------------

# levers of the snapshot comparison, at the tiny model (max_len 32)
SNAPSHOT_LEVERS = {"off": {}, "prefix": dict(prefix_cache=1),
                   "chunked": dict(prefill_chunk=4),
                   "spec": dict(spec_ngram=1, spec_lookahead=2)}


@pytest.mark.parametrize("leg", sorted(SNAPSHOT_LEVERS))
def test_debug_snapshot_equals_the_jax_engines_midrun(leg, tiny, metrics_on,
                                                      tmp_path, monkeypatch):
    """The same requests, weights, levers and (frozen) clock through both
    engines: after one step and after the drain, every key of the JAX
    engine's snapshot (the lever sections, the compile rows of every site
    and the SLO section included) has the same value in the port's, the
    schema name aside. The second prompt shares the first's first page,
    so the prefix leg maps a cached page."""
    monkeypatch.setenv("MXTPU_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    levers = SNAPSHOT_LEVERS[leg]
    jcfg = jtfm.TransformerConfig(**TINY)
    mon = dict(window_short=2, window_long=4, min_samples=1, dump=False)
    engines = {
        "torch": _engine(tiny, slots=1, clock=lambda: 0.0,
                         slo=_slo.SLOMonitor([_slo.Objective(
                             "request_latency", 1.0)], **mon), **levers),
        "jax": JaxEngine(jtfm.init_params(jcfg, seed=0), jcfg, slots=1,
                         page_size=8, num_pages=16, clock=lambda: 0.0,
                         slo=jslo.SLOMonitor([jslo.Objective(
                             "request_latency", 1.0)], **mon), **levers)}
    first = _prompt(11)
    second = np.concatenate([first[:9], _prompt(3, seed=1)])
    for eng in engines.values():
        eng.submit(first, 8)
        eng.submit(second, 4)
        eng.step()
    snaps = {k: eng.debug_snapshot() for k, eng in engines.items()}
    json.dumps(snaps["torch"])
    assert snaps["torch"]["queue_depth"] == 1
    if leg == "off":
        assert snaps["torch"]["compile"] == {
            "serving_decode_step": {"signatures": 1, "retraces": 0},
            "serving_prefill_b16": {"signatures": 1, "retraces": 0}}
    for _ in range(2):
        assert snaps["torch"]["schema"] == ("mxtpu-torch-serving-engine-"
                                            "debug-v2")
        want = {k: v for k, v in snaps["jax"].items() if k != "schema"}
        assert {k: snaps["torch"][k] for k in want} == want
        for eng in engines.values():
            eng.run()
        snaps = {k: eng.debug_snapshot() for k, eng in engines.items()}
    assert snaps["torch"]["requests_finished"] == 2
    assert snaps["torch"]["slo"]["request_latency"]["samples"] == 2
    if leg == "prefix":
        assert snaps["torch"]["prefix_cache"]["hits"] == 1


def test_debug_endpoint_http(tiny, monkeypatch):
    eng = _engine(tiny)
    eng.submit(_prompt(4), 3)
    eng.run()
    srv = _exporters.start_http_server(0, host="127.0.0.1")
    try:
        url = f"http://127.0.0.1:{srv.port}/debug/engine"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url)  # gated off without the knob
        assert err.value.code == 404
        monkeypatch.setenv("MXTPU_DEBUG_ENDPOINTS", "1")
        with urllib.request.urlopen(url) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            snap = json.loads(resp.read().decode())
        assert snap["schema"] == "mxtpu-torch-serving-engine-debug-v2"
        assert snap["requests_finished"] == 1
        assert snap["device"] == "cpu"
        assert snap["prefix_cache"] is None
        assert snap["speculation"] is None
        assert snap["chunked_prefill"] is None
    finally:
        srv.close()


def test_serving_top_renders_the_ports_snapshot(tiny, metrics_on):
    top = _serving_top()
    eng = _engine(tiny, slots=1)
    eng.submit(_prompt(4), 8)
    eng.submit(_prompt(5, seed=1), 4)
    eng.step()
    text = top.render(eng.debug_snapshot())
    assert "decoding" in text and "queued" in text
    assert "serving_decode_step" in text
    assert "goodput" in text
    eng.run()
    assert "idle" in top.render(eng.debug_snapshot())


# -- warm() and the capture registry -----------------------------------------

LEVERS = {"off": {}, "prefix": dict(prefix_cache=1),
          "chunked": dict(prefill_chunk=8),
          "spec": dict(spec_ngram=2, spec_lookahead=4),
          "prefix+spec": dict(prefix_cache=1, spec_ngram=2)}
TRACE_ARGS = {"prefix": dict(shared_prefix_frac=0.5, prefix_len=32),
              "prefix+spec": dict(shared_prefix_frac=0.5, prefix_len=32)}


@pytest.mark.parametrize("leg", sorted(LEVERS))
def test_warm_lists_every_site_and_the_trace_captures_nothing(leg,
                                                              metrics_on):
    """warm() returns every site the levers call (the JAX rule for the
    wide widths), touches no KV page but the null page, and after it the
    seeded trace registers no signature, warm-up wave included."""
    cfg = tfm.TransformerConfig(**SMALL)
    params = tfm.init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(params, cfg, slots=3, page_size=8, device="cpu",
                        **LEVERS[leg])
    statuses = eng.warm()
    wide = {"off": [], "prefix": [32], "chunked": [8], "spec": [5],
            "prefix+spec": [5, 32]}[leg]
    want = {"serving_decode_step", "serving_prefill_b16",
            "serving_prefill_b32", "serving_prefill_b64",
            *(f"serving_wide_q{q}" for q in wide)}
    if "prefix" in leg:
        want.add("serving_page_copy")
    assert statuses == {site: "eager" for site in want}
    assert set(eng.sites()) == want
    assert eng.warm() == {site: "memo" for site in want}
    for pool in eng.paged.values():
        assert not pool[:, 1:].any(), "warm() wrote outside the null page"
    out = run_trace(params, cfg, n_requests=12, seed=0, engine=eng,
                    verify_tokens=True, **TRACE_ARGS.get(leg, {}))
    assert (out["warmup_compiles"], out["steady_compiles"],
            out["steady_retraces"], out["dense_fallbacks"]) == (0, 0, 0, 0)
    assert out["token_identity"] == 1.0
    snap = compilereg.snapshot()
    assert {fn: v["signatures"] for fn, v in snap.items()} == {
        site: 1 for site in want}
    assert eng.debug_snapshot()["compile"] == {
        site: {"signatures": 1, "retraces": 0} for site in want}


def test_trace_restores_telemetry_and_reports_registry_deltas():
    """run_trace turns telemetry on for its call (the capture registry
    counts only then) and off again; a fresh engine's warm-up wave
    registers its first signatures, the measured phase none."""
    assert not telemetry.enabled()
    compilereg.reset()
    cfg = tfm.TransformerConfig(**SMALL)
    params = tfm.init_params(cfg, seed=0, device="cpu")
    try:
        out = run_trace(params, cfg, n_requests=12, slots=3, page_size=8,
                        seed=0, device="cpu")
        assert not telemetry.enabled()
        assert out["warmup_compiles"] == 3  # decode + buckets 16 and 32
        assert (out["steady_compiles"], out["steady_retraces"]) == (0, 0)
        assert set(compilereg.snapshot()) == {
            "serving_decode_step", "serving_prefill_b16",
            "serving_prefill_b32"}
    finally:
        compilereg.reset()
        telemetry.REGISTRY.reset()
