"""The port's profiler against the JAX package's (CPU): the per-op
aggregate table (`set_config(aggregate_stats=True)`, `set_state("run")`,
`dumps()`) has the same names and counts for the same op sequence (nd
ops, a gluon net called with NDArrays, an LSTM layer), `pause` /
`resume` and `reset_stats`, telemetry spans charging the table, the
Domain / Task / Frame / Event / Counter / Marker objects, the chrome
trace `dump()` writes, and the one-session rule: a window inside a
caller's `torch.profiler` session shares it and writes no trace.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import profiler as jprof
from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu_torch import profiler as tprof
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params

CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def fresh(tmp_path):
    """Both profilers stopped, empty and at their default settings
    before and after each test; traces under the test's directory."""
    for prof in (jprof, tprof):
        prof.set_config(filename=str(tmp_path / "profile.json"),
                        aggregate_stats=False, profile_all=False)
        prof.reset_stats()
    yield
    for prof in (jprof, tprof):
        prof.set_state("stop")
        prof.resume()
        prof.reset_stats()
        prof.set_config(filename="profile.json", aggregate_stats=False,
                        profile_all=False)


def _table(text):
    """{name: count} of a `dumps()` table."""
    rows = {}
    for line in text.splitlines()[3:]:
        m = re.match(r"(\S+)\s+(\d+)\s+[\d.]+\s+[\d.]+\s+[\d.]+\s+[\d.]+$",
                     line)
        if m:
            rows[m.group(1)] = int(m.group(2))
    return rows


def _net(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu"))
        net.add(mx.gluon.nn.Dropout(0.5))
        net.add(mx.gluon.nn.Dense(3))
    return net


def _lstm(mx):
    return mx.gluon.rnn.LSTM(6, num_layers=2, layout="NTC")


def _sequence(mx, ctx, nets):
    """The op sequence both packages run in the window: nd ops, a net
    called with NDArrays (recorded and backward), an LSTM layer with and
    without states."""
    rng = np.random.RandomState(0)
    x = mx.nd.array(rng.randn(4, 5).astype(np.float32), ctx=ctx)
    y = mx.nd.relu(x) + mx.nd.exp(x)
    mx.nd.sum(mx.nd.dot(y, mx.nd.transpose(y)))
    net, lstm = nets
    with mx.autograd.record():
        out = net(x)
        loss = mx.nd.mean(out)
    loss.backward()
    seq = mx.nd.array(rng.randn(2, 3, 5).astype(np.float32), ctx=ctx)
    lstm(seq)
    states = [mx.nd.array(np.zeros((2, 2, 6), np.float32), ctx=ctx)
              for _ in range(2)]
    lstm(seq, states)
    for _ in range(3):
        mx.nd.tanh(x)


def _nets(mx, ctx, weights=None):
    net, lstm = _net(mx), _lstm(mx)
    for block in (net, lstm):
        if mx is jmx:
            block.initialize(jmx.init.Xavier())
        else:
            block.initialize(tmx.init.Xavier(), device="cpu")
    if weights is None:
        x = mx.nd.array(np.zeros((4, 5), np.float32), ctx=ctx)
        net(x)
        lstm(mx.nd.array(np.zeros((2, 3, 5), np.float32), ctx=ctx))
    else:
        for block, w in zip((net, lstm), weights):
            load_numpy_params(block, w, prefix="")
    return net, lstm


def _values(block):
    return {n[len(block.prefix):]: p.data().asnumpy()
            for n, p in block.collect_params().items()}


def test_aggregate_names_and_counts_match_jax():
    jnets = _nets(jmx, jmx.cpu())
    tnets = _nets(tmx, CPU, [_values(b) for b in jnets])
    tables = []
    for mx, prof, ctx, nets in ((jmx, jprof, jmx.cpu(), jnets),
                                (tmx, tprof, CPU, tnets)):
        prof.set_config(aggregate_stats=True)
        prof.set_state("run")
        _sequence(mx, ctx, nets)
        prof.set_state("stop")
        tables.append(_table(prof.dumps()))
    assert tables[1] == tables[0]
    for name in ("RNN", "FullyConnected", "Dropout", "tanh"):
        assert name in tables[1], name
    assert tables[1]["RNN"] == 2 and tables[1]["tanh"] == 3


def test_pause_resume_and_reset():
    tprof.set_config(aggregate_stats=True)
    tprof.set_state("run")
    x = tmx.nd.ones((3,), ctx=CPU)
    tmx.nd.relu(x)
    tprof.pause()
    tmx.nd.relu(x)
    tmx.nd.exp(x)
    tprof.resume()
    tmx.nd.relu(x)
    tprof.set_state("stop")
    tmx.nd.relu(x)  # outside the window
    assert _table(tprof.dumps()) == {"relu": 2}
    text = tprof.dumps(reset=True, sort_by="count")
    assert "relu" in text
    assert "(no ops recorded)" in tprof.dumps()
    with pytest.raises(ValueError):
        tprof.dumps(sort_by="median")
    with pytest.raises(ValueError):
        tprof.set_state("pause")


def test_spans_feed_the_table(monkeypatch):
    """With telemetry on and aggregate stats running, a span's duration
    lands in the table under its name, in both packages."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    for tel in (jtel, ttel):
        tel.refresh_from_env()
    try:
        rows = []
        for tel, prof in ((jtel, jprof), (ttel, tprof)):
            prof.set_config(aggregate_stats=True)
            prof.set_state("run")
            for _ in range(2):
                with tel.span("serving.step", step=0):
                    pass
            prof.set_state("stop")
            rows.append(_table(prof.dumps()))
        assert rows[1] == rows[0] == {"serving.step": 2}
    finally:
        monkeypatch.delenv("MXNET_TELEMETRY")
        for tel in (jtel, ttel):
            tel.refresh_from_env()


def test_timed_invoke_and_record_duration():
    out = tprof.timed_invoke("custom", lambda a: a * 2, torch.ones(3))
    torch.testing.assert_close(out, torch.full((3,), 2.0))
    tprof.record_duration("custom", 0.5)
    assert _table(tprof.dumps()) == {"custom": 2}
    assert not tprof.aggregate_enabled()


def test_dump_writes_a_chrome_trace_of_the_window(tmp_path):
    tprof.set_config(filename=str(tmp_path / "run.json"))
    net, lstm = _nets(tmx, CPU)
    tprof.set_state("run")
    lstm(tmx.nd.array(np.ones((2, 3, 5), np.float32), ctx=CPU))
    with tprof.Task(tprof.Domain("lm"), "train_step"):
        tmx.nd.relu(tmx.nd.ones((3,), ctx=CPU))
    tprof.Marker(tprof.Domain("lm"), "epoch_end").mark()
    out = tprof.dump()
    assert out == str(tmp_path / "run_trace")
    with open(os.path.join(out, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"RNN", "relu", "train_step", "epoch_end"} <= names
    assert tprof.dump() == out  # a second dump: nothing is running


def test_a_window_inside_a_callers_session_shares_it(tmp_path):
    """set_state("run") opens no session; ops inside a caller's
    torch.profiler window are annotated there and the port writes no
    trace of its own, so the caller's session keeps working."""
    tprof.set_config(filename=str(tmp_path / "shared.json"))
    tprof.set_state("run")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tmx.nd.relu(tmx.nd.ones((3,), ctx=CPU))
        with ttel.span("serving.step"):
            pass
    tprof.set_state("stop")
    assert "relu" in {e.name for e in prof.events()}
    assert not os.path.exists(tmp_path / "shared_trace")
    assert tmx.nd.F.relu is tmx.ops.registry.OP_REGISTRY["relu"].fn


def test_instrumentation_objects_match_jax():
    for prof in (jprof, tprof):
        dom = prof.Domain("lm")
        assert repr(dom) == "Domain(name=lm)"
        c = dom.new_counter("tokens", 5)
        c += 3
        c -= 1
        c.increment(10)
        c.decrement(2)
        c.set_value(c.value * 2)
        assert c.value == 30 and c.domain is dom
        t = dom.new_task("step")
        assert t.domain is dom and t.name == "step"
        for cls in (prof.Task, prof.Frame):
            with cls(dom, "x") as obj:
                assert obj.name == "x"
        e = prof.Event("solo")
        e.start()
        e.stop()
        with pytest.raises(TypeError):
            prof.Task(dom)
        dom.new_marker("m").mark()


def test_memory_table():
    stats = tprof.memory_analysis(lambda a: a @ a.t(), torch.ones(64, 32),
                                  name="gram")
    assert stats["argument_bytes"] == 64 * 32 * 4
    assert stats["output_bytes"] == 64 * 64 * 4
    assert stats["peak_bytes"] == (stats["argument_bytes"]
                                   + stats["output_bytes"])
    assert "gram" in tprof.dumps_memory()
