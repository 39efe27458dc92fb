"""The port's `gluon.Trainer` update paths against the JAX package's, on
the CPU: the aggregated bucket update against the per-parameter one
(rtol 1e-5, atol 1e-7, bench.py's `weights_match`) and against JAX's
(rtol 1e-5, atol 1e-6); `mxtpu_trainer_dispatches_total` equal to JAX's
exactly for the same net, knob and fallbacks; `save_states` files
loaded across both packages; and the port's bench `--dispatch-overhead`
mode giving `ci/perf_baseline.json`'s deterministic counters.
"""
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

CPU = tmx.cpu()
SHAPES = [(16, 8), (16,), (64, 16), (64,), (3, 64), (3,)]


@pytest.fixture(autouse=True)
def telemetry_on():
    """Counters count only with telemetry on; each package is turned
    back off (and its counter reset) afterwards."""
    for mx in (jmx, tmx):
        mx.telemetry.enable()
    yield
    for mx in (jmx, tmx):
        mx.telemetry.disable()


def _net(mx, ctx):
    net = mx.gluon.nn.Sequential(prefix="agg_")
    net.add(mx.gluon.nn.Dense(16, in_units=8, prefix="agg_a_"),
            mx.gluon.nn.Dense(64, in_units=16, prefix="agg_b_"),
            mx.gluon.nn.Dense(3, in_units=64, prefix="agg_c_"))
    kw = {} if ctx is None else {"ctx": ctx}
    net.initialize(mx.init.Zero(), **kw)
    rng = np.random.RandomState(0)
    for p in net.collect_params().values():
        p.set_data(mx.nd.array(0.1 * rng.randn(*p.shape).astype(np.float32),
                               **kw))
    return net


def _train(mx, optimizer, params, knob, steps=3, ignore_stale_grad=False,
           monkeypatch=None, ctx=None):
    """(final weights, {path: dispatches}) of `steps` Trainer steps."""
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", str(knob))
    net = _net(mx, ctx)
    kw = {} if ctx is None else {"ctx": ctx}
    tr = mx.gluon.Trainer(net.collect_params(), optimizer, params)
    rng = np.random.RandomState(1)
    c = mx.telemetry.counter("mxtpu_trainer_dispatches_total")
    before = {p: c.value(kind="optimizer_update", path=p)
              for p in ("aggregated", "per_param")}
    for _ in range(steps):
        x = mx.nd.array(0.5 * rng.randn(4, 8).astype(np.float32), **kw)
        with mx.autograd.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(4, ignore_stale_grad=ignore_stale_grad)
    counts = {p: c.value(kind="optimizer_update", path=p) - before[p]
              for p in before}
    weights = [p.data().asnumpy() for p in net.collect_params().values()]
    return weights, counts, tr


OPTS = [("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}),
        ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
        ("rmsprop", {"learning_rate": 0.01, "centered": True}),
        ("ftml", {"learning_rate": 0.05}),
        ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9})]


@pytest.mark.parametrize("name,params", OPTS, ids=[o[0] for o in OPTS])
def test_aggregated_update_equals_per_parameter_and_jax(name, params,
                                                         monkeypatch):
    per, _, _ = _train(tmx, name, params, 0, monkeypatch=monkeypatch,
                       ctx=CPU)
    agg, counts, _ = _train(tmx, name, params, 4096,
                            monkeypatch=monkeypatch, ctx=CPU)
    jagg, jcounts, _ = _train(jmx, name, params, 4096,
                              monkeypatch=monkeypatch)
    assert counts == jcounts == {"aggregated": 3, "per_param": 0}
    for a, b, j in zip(agg, per, jagg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(a, j, rtol=1e-5, atol=1e-6)


CASES = {
    # (optimizer, params, knob KB, ignore_stale_grad)
    "one_bucket": ("sgd", {"momentum": 0.9}, 4096, False),
    "byte_cap": ("sgd", {"momentum": 0.9}, 4, False),
    "knob_off": ("sgd", {"momentum": 0.9}, 0, False),
    "stale_grad": ("adam", {}, 4096, True),
    "nadam": ("nadam", {}, 4096, False),
    "sgld": ("sgld", {}, 4096, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_counters_equal_jax(case, monkeypatch):
    name, params, knob, stale = CASES[case]
    _, counts, _ = _train(tmx, name, params, knob, steps=2,
                          ignore_stale_grad=stale, monkeypatch=monkeypatch,
                          ctx=CPU)
    _, jcounts, _ = _train(jmx, name, params, knob, steps=2,
                           ignore_stale_grad=stale, monkeypatch=monkeypatch)
    assert counts == jcounts, (counts, jcounts)
    assert sum(counts.values()) > 0


def test_a_users_optimizer_stays_per_parameter(monkeypatch):
    class Plain(tmx.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            weight._data = weight._data - self.lr * grad._data

    class JPlain(jmx.optimizer.Optimizer):
        def update(self, index, weight, grad, state):
            weight._data = weight._data - self.lr * grad._data

    w, counts, _ = _train(tmx, Plain(learning_rate=0.1), None, 4096,
                          steps=2, monkeypatch=monkeypatch, ctx=CPU)
    jw, jcounts, _ = _train(jmx, JPlain(learning_rate=0.1), None, 4096,
                            steps=2, monkeypatch=monkeypatch)
    assert counts == jcounts == {"aggregated": 0, "per_param": 12}
    for a, b in zip(w, jw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,params", [OPTS[0], OPTS[1]],
                         ids=["sgd", "adam"])
def test_save_states_files_load_across_packages(name, params, tmp_path,
                                                monkeypatch):
    """A float32 `save_states` file of either package, loaded by the
    other, gives the writer's states (Adam's as (mean, var) tuples), on
    the device of the states they replace."""
    _, _, ttr = _train(tmx, name, params, 4096, steps=2,
                       monkeypatch=monkeypatch, ctx=CPU)
    _, _, jtr = _train(jmx, name, params, 4096, steps=2,
                       monkeypatch=monkeypatch)
    ttr.save_states(str(tmp_path / "port.states"))
    jtr.save_states(str(tmp_path / "jax.states"))
    jtr.load_states(str(tmp_path / "port.states"))
    ttr.load_states(str(tmp_path / "jax.states"))
    for k, js in jtr._updater.states.items():
        ts = ttr._updater.states[k]
        for a, b in zip(ts if isinstance(ts, tuple) else (ts,),
                        js if isinstance(js, tuple) else (js,)):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-5,
                                       atol=1e-6)
            assert a._data.device.type == "cpu"
    assert isinstance(ttr._updater.states[0],
                      tuple if name == "adam" else tmx.nd.NDArray)


def test_bench_dispatch_mode_gives_the_baseline_counters():
    """`python3 -m incubator_mxnet_tpu_torch.bench --dispatch-overhead`'s
    deterministic keys, as `ci/perf_baseline.json` holds them for the
    JAX package: 200 parameters, 5 steps, 1000 per-parameter and 5
    aggregated dispatches, equal weights."""
    from incubator_mxnet_tpu_torch import bench

    knob = os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE")
    out = bench.dispatch_overhead_main(assert_mode=True, ctx=CPU)
    assert os.environ.get("MXNET_OPTIMIZER_AGGREGATION_SIZE") == knob
    assert (out["params"], out["steps"], out["per_param_dispatches"],
            out["aggregated_dispatches"], out["weights_match"]) == \
        (200, 5, 1000, 5, True)
    assert out["metric"] == "trainer_dispatch_overhead"
    assert torch.get_default_dtype() == torch.float32
