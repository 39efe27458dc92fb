"""The port's training telemetry against the JAX package's, on the CPU:
memory watermarks at step boundaries (the host alone here, as JAX's CPU
backend has it), the TensorBoard callbacks' keys for the same registry
content, `Trainer.step`'s step boundary, and the port's bench
`--observatory` mode with `ci/perf_baseline.json`'s deterministic
counters (16 steps, 0 retraces, 0 anomalies).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.model import BatchEndParam

CPU = tmx.cpu()


class Writer:
    """An injected summary writer: records (tag, value, step)."""

    def __init__(self):
        self.scalars, self.flushes = [], 0

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def flush(self):
        self.flushes += 1


def _fill(registry):
    registry.counter("mxtpu_trainer_steps_total", "steps").inc(3)
    g = registry.gauge("mxtpu_device_bytes_in_use", "bytes")
    g.set(1024, device="host")
    g.set(2048, device="cuda:0")
    h = registry.histogram("mxtpu_trainer_step_seconds", "secs")
    for v in (0.01, 0.02, 0.04):
        h.observe(v)
    return registry


def test_memory_gauges_sample_the_host_as_jax():
    regs = [_fill(mx.telemetry.MetricsRegistry()) for mx in (tmx, jmx)]
    sampled = [mx.telemetry.sample_device_memory(r)
               for mx, r in zip((tmx, jmx), regs)]
    assert sampled[0] == sampled[1] == {"host"}
    for r in regs:
        g = r.get("mxtpu_device_bytes_in_use")
        assert g.value(device="host") > 0
        assert r.get("mxtpu_device_peak_bytes_in_use").value(
            device="host") > 0


def test_tensorboard_callback_keys_match_jax():
    got = []
    for mx in (tmx, jmx):
        w = Writer()
        cb = mx.telemetry.LogTelemetryCallback(
            interval=2, registry=_fill(mx.telemetry.MetricsRegistry()),
            summary_writer=w)
        for _ in range(4):
            cb(None)
        got.append(sorted(w.scalars))
    assert got[0] == got[1] and len(got[0]) == 2 * 6


def test_log_metrics_callback_with_an_injected_writer():
    w = Writer()
    cb = tmx.contrib.tensorboard.LogMetricsCallback(
        None, prefix="train", summary_writer=w)
    m = tmx.metric.create(["acc", "ce"])
    label = tmx.nd.array(np.array([0, 1, 1], np.float32), ctx=CPU)
    pred = tmx.nd.array(np.array([[0.9, 0.1], [0.3, 0.7], [0.6, 0.4]],
                                 np.float32), ctx=CPU)
    m.update([label], [pred])
    cb(BatchEndParam(0, 1, m, {}))
    tags = [t for t, _, _ in w.scalars]
    assert tags == ["train/accuracy", "train/cross-entropy"]
    assert w.scalars[0][1] == pytest.approx(2 / 3)


def test_trainer_step_is_a_step_boundary():
    tmx.telemetry.enable()
    try:
        c = tmx.telemetry.counter("mxtpu_trainer_steps_total")
        before = c.value()
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize(tmx.init.One(), ctx=CPU)
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        for _ in range(2):
            with tmx.autograd.record():
                loss = net(tmx.nd.ones((4, 3), ctx=CPU)).sum()
            loss.backward()
            tr.step(4)
        assert c.value() - before == 2
        g = tmx.telemetry.REGISTRY.get("mxtpu_device_bytes_in_use")
        assert g.value(device="host") > 0
    finally:
        tmx.telemetry.disable()


def test_bench_observatory_mode_gives_the_baseline_counters():
    from incubator_mxnet_tpu_torch import bench

    try:
        out = bench.observatory_main(ctx=CPU)
    finally:
        tmx.telemetry.disable()
    assert (out["steps"], out["retraces_epoch1"], out["retraces_epoch2"],
            out["anomalies"]) == (16, 0, 0, 0)
    assert out["hbm_peak_bytes"] > 0 and out["hbm_peak_span"]
    assert set(out["phases"]) >= {"dispatch", "optimizer_update",
                                  "device_sync"}
