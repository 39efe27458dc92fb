"""The port's `contrib.amp` and the Trainer's loss-scaled step against the
JAX package's on the CPU: `convert_block` / `convert_model` dtypes, the
dynamic loss scaler's trail, gauge and events on one sequence of
overflow flags, the JAX package's own amp trainer scenarios
(`tests/test_contrib.py:229-377`) run in both packages with weights at
rtol 1e-6, the `backoff` guardrail policy and the refusal of amp with
server-side updates; then a float16 channels-last ResNet through
`convert_block(net, "float16")`, the default scaler and multi-precision
SGD, with the fused epilogue's plain versions (`MXTPU_FUSED_EPILOGUE=1`)
against JAX's float16 steps."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.contrib import amp as jamp
from incubator_mxnet_tpu.resilience import fault as jfault
from incubator_mxnet_tpu_torch.contrib import amp as tamp
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params
from incubator_mxnet_tpu_torch.resilience import fault as tfault

CPU = tmx.cpu()
BOTH = ((tmx, tamp), (jmx, jamp))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nd(mx, a):
    return mx.nd.array(a, ctx=CPU) if mx is tmx else mx.nd.array(a)


def _dense(mx, seed):
    """Dense(2, in_units=3) with numpy-drawn weights (the same in both
    packages) and plain SGD at lr 0.1."""
    rng = np.random.RandomState(seed)
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(mx.init.Zero(), **({"device": "cpu"} if mx is tmx
                                      else {}))
    net.weight.set_data(_nd(mx, rng.randn(2, 3).astype(np.float32)))
    net.bias.set_data(_nd(mx, rng.randn(2).astype(np.float32)))
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    return net, tr


def _weights(net):
    """Copies (a CPU array's asnumpy() shares the parameter's memory)."""
    return [p.data().asnumpy().copy()
            for p in net.collect_params().values()]


def _close(got, want, rtol=1e-6, atol=1e-6):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("target", ["float16", "bfloat16"])
def test_convert_block_and_model_dtypes_match_jax(target):
    dtypes = []
    for mx, amp in BOTH:
        nn = mx.gluon.nn
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(4, in_units=3), nn.BatchNorm(in_channels=4),
                    nn.Conv2D(2, 1, in_channels=4))
        net.initialize(**({"device": "cpu"} if mx is tmx else {}))
        assert amp.convert_block(net, target) is net
        args = {"fc_weight": _nd(mx, np.ones((2, 2), np.float32)),
                "bn_gamma": _nd(mx, np.ones(2, np.float32)),
                "bn_moving_var": _nd(mx, np.ones(2, np.float32))}
        sym, new_args, aux = amp.convert_model("sym", args, {"a": 1},
                                               target)
        assert sym == "sym" and aux == {"a": 1}
        dtypes.append(
            [(k[len(net.prefix):], np.dtype(p.data().dtype).name)
             for k, p in net.collect_params().items()]
            + [(k, np.dtype(v.dtype).name) for k, v in new_args.items()])
    assert dtypes[0] == dtypes[1]
    kept = {k: d for k, d in dtypes[0]}
    assert kept["dense0_weight"] == target and \
        kept["batchnorm0_gamma"] == kept["batchnorm0_running_var"] == \
        kept["bn_gamma"] == "float32" and kept["fc_weight"] == target


def test_scaler_trail_gauge_and_events_match_jax():
    """One sequence of overflow flags through both scalers (window 3,
    floor 0.5): the scale after each update, the mxtpu_loss_scale gauge
    and the loss_scale_change events (scale, prev, cause) agree."""
    flags = [False, False, False, True, False, True, True, True, True,
             True, False, False, False, False, False, False]
    runs = []
    for mx, amp in BOTH:
        tel = mx.telemetry
        was = tel.enabled()
        tel.enable()
        try:
            s = amp.DynamicLossScaler(init_scale=4.0, scale_window=3,
                                      min_scale=0.5)
            start = len(tel.recorder.snapshot())
            trail, gauge = [], []
            for f in flags:
                s.update_scale(f)
                trail.append(s.loss_scale)
                gauge.append(tel.gauge("mxtpu_loss_scale").value())
            events = [(e["scale"], e["prev"], e["cause"])
                      for e in tel.recorder.snapshot()[start:]
                      if e["kind"] == "loss_scale_change"]
        finally:
            if not was:
                tel.disable()
        runs.append((trail, gauge, events, s._unskipped))
    assert runs[0] == runs[1]
    trail, gauge, events, _ = runs[0]
    assert trail == gauge and trail[2] == 8.0 and min(trail) == 0.5
    assert len(events) == len({(a, b) for a, b, _ in events}) > 4


def test_has_overflow_reads_dense_sparse_and_arrays():
    s = tamp.DynamicLossScaler()
    g = tmx.nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    bad = tmx.nd.array(np.array([1.0, np.inf], np.float32), ctx=CPU)
    rsp = tmx.nd.sparse.row_sparse_array(
        (np.array([[np.nan, 1.0]], np.float32), [2]), shape=(4, 2), ctx=CPU)
    assert not s.has_overflow([g, torch.ones(3)])
    assert s.has_overflow([g, bad]) and s.has_overflow([rsp])
    assert not s.has_overflow([])


def test_scale_loss_records_outside_record():
    """`scale_loss` outside record() still puts its multiply on the tape:
    the gradients are the scale times the unscaled ones, as in JAX."""
    grads = []
    for mx, amp in BOTH:
        net, tr = _dense(mx, 5)
        amp.init_trainer(tr, amp.DynamicLossScaler(init_scale=2 ** 5))
        x = _nd(mx, np.random.RandomState(6).rand(4, 3).astype(np.float32))
        with mx.autograd.record():
            loss = net(x).sum()
        with amp.scale_loss(loss, tr) as scaled:
            scaled.backward()
        grads.append(net.weight.grad().asnumpy())
        assert tr._amp_applied_scale == 2 ** 5
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6)
    np.testing.assert_allclose(grads[0] / 32, np.tile(
        np.random.RandomState(6).rand(4, 3).astype(np.float32).sum(0),
        (2, 1)), rtol=1e-6)


def _scaled_steps(mx, amp, seed, scaler, scale=None, poison=False):
    """3 loss-scaled steps of tests/test_contrib.py's L2 regression (the
    user's `scale` override when given), then one step on a loss poisoned
    to overflow when `poison`."""
    net, tr = _dense(mx, seed)
    s = amp.init_trainer(tr, scaler)
    rng = np.random.RandomState(seed)
    x = _nd(mx, rng.rand(4, 3).astype(np.float32))
    y = _nd(mx, rng.rand(4, 2).astype(np.float32))
    L = mx.gluon.loss.L2Loss()
    for _ in range(3):
        with mx.autograd.record():
            loss = L(net(x), y)
        with amp.scale_loss(loss, tr, scale=scale) as scaled:
            scaled.backward()
        tr.step(4)
    before = _weights(net)
    if poison:
        with mx.autograd.record():
            loss = L(net(x * _nd(mx, np.float32(1e38))), y) * 1e38
        with amp.scale_loss(loss, tr) as scaled:
            scaled.backward()
        tr.step(4)
    return net, s, before


def _plain_steps(mx, seed):
    net, tr = _dense(mx, seed)
    rng = np.random.RandomState(seed)
    x = _nd(mx, rng.rand(4, 3).astype(np.float32))
    y = _nd(mx, rng.rand(4, 2).astype(np.float32))
    L = mx.gluon.loss.L2Loss()
    for _ in range(3):
        with mx.autograd.record():
            loss = L(net(x), y)
        loss.backward()
        tr.step(4)
    return net


def test_amp_dynamic_loss_scaling_trainer_matches_jax():
    """tests/test_contrib.py::test_amp_dynamic_loss_scaling_trainer in
    both packages: scaled training equals unscaled training, and an
    overflowed step leaves the weights bit-equal and halves the scale."""
    out = []
    for mx, amp in BOTH:
        net, s, before = _scaled_steps(
            mx, amp, 9, amp.DynamicLossScaler(init_scale=2 ** 10),
            poison=True)
        _close(before, _weights(_plain_steps(mx, 9)), 1e-5, 1e-6)
        for g, w in zip(_weights(net), before):
            np.testing.assert_array_equal(g, w)
        assert s.loss_scale == 2 ** 9
        out.append(_weights(net))
    _close(out[0], out[1])


def test_amp_scaler_grows_after_window_matches_jax():
    for _mx, amp in BOTH:
        s = amp.DynamicLossScaler(init_scale=4.0, scale_window=3)
        for _ in range(3):
            s.update_scale(False)
        assert s.loss_scale == 8.0
        s.update_scale(True)
        assert s.loss_scale == 4.0 and s._unskipped == 0


def test_amp_overflow_guard_at_scale_one_matches_jax():
    for mx, amp in BOTH:
        net, tr = _dense(mx, 3)
        amp.init_trainer(tr, amp.DynamicLossScaler(init_scale=1.0))
        before = _weights(net)
        x = _nd(mx, np.full((2, 3), 1e38, np.float32))
        with mx.autograd.record():
            loss = mx.gluon.loss.L2Loss()(
                net(x) * _nd(mx, np.float32(1e38)),
                _nd(mx, np.zeros((2, 2), np.float32)))
        with amp.scale_loss(loss, tr) as scaled:
            assert scaled is loss  # scale 1.0: the loss itself
            scaled.backward()
        tr.step(2)
        for g, w in zip(_weights(net), before):
            np.testing.assert_array_equal(g, w)


def test_amp_explicit_scale_override_unscales_matches_jax():
    out = []
    for mx, amp in BOTH:
        net, _, _ = _scaled_steps(
            mx, amp, 13, amp.DynamicLossScaler(init_scale=2 ** 16),
            scale=128.0)
        _close(_weights(net), _weights(_plain_steps(mx, 13)), 1e-5, 1e-6)
        out.append(_weights(net))
    _close(out[0], out[1])


def test_amp_manual_update_flow_unscales_matches_jax():
    """allreduce_grads() + update() honour the scaler as step() does."""
    out = []
    for mx, amp in BOTH:
        net, tr = _dense(mx, 7)
        amp.init_trainer(tr, amp.DynamicLossScaler(init_scale=2 ** 8))
        rng = np.random.RandomState(2)
        x = _nd(mx, rng.rand(4, 3).astype(np.float32))
        y = _nd(mx, rng.rand(4, 2).astype(np.float32))
        with mx.autograd.record():
            loss = mx.gluon.loss.L2Loss()(net(x), y)
        with amp.scale_loss(loss, tr) as scaled:
            scaled.backward()
        w0 = net.weight.data().asnumpy().copy()
        g = net.weight.grad().asnumpy().copy()
        tr.allreduce_grads()
        tr.update(4)
        np.testing.assert_allclose(net.weight.data().asnumpy(),
                                   w0 - 0.1 * (g / 2 ** 8) / 4, rtol=1e-5,
                                   atol=1e-6)
        out.append(_weights(net))
    _close(out[0], out[1])


def _trip_count(mx):
    return mx.telemetry.counter("mxtpu_guardrail_trips_total").value(
        policy="backoff", reason="nonfinite-grad")


def test_backoff_guardrail_matches_jax(monkeypatch):
    """MXTPU_GUARDRAIL_POLICY=backoff with the fault injector's
    grad.nonfinite at step 2: that step is skipped (the weights stay
    bit-equal), the trip counter goes up by one, a unit scaler pinned at
    1.0 is attached and stays there; the clean steps around it update as
    without amp. Then with an amp scaler attached the trip halves it."""
    monkeypatch.setenv("MXTPU_GUARDRAIL_POLICY", "backoff")
    out = []
    for mx, fault, amp in ((tmx, tfault, tamp), (jmx, jfault, jamp)):
        tel = mx.telemetry
        was = tel.enabled()
        tel.enable()
        fault.install(fault.FaultInjector("grad.nonfinite:fail@2", 0))
        try:
            net, tr = _dense(mx, 11)
            x = _nd(mx, np.random.RandomState(1).rand(4, 3)
                    .astype(np.float32))
            trips0 = _trip_count(mx)
            seen = []
            for step in range(4):
                with mx.autograd.record():
                    loss = net(x).sum()
                loss.backward()
                before = _weights(net)
                tr.step(4)
                moved = any((a != b).any()
                            for a, b in zip(_weights(net), before))
                scaler = getattr(tr, "_amp_scaler", None)
                seen.append((moved, None if scaler is None
                             else scaler.loss_scale))
            assert seen == [(True, None), (False, 1.0), (True, 1.0),
                            (True, 1.0)]
            assert _trip_count(mx) == trips0 + 1
            out.append(_weights(net))
            # with amp's scaler attached the trip halves it
            net, tr = _dense(mx, 11)
            s = amp.init_trainer(tr, amp.DynamicLossScaler(init_scale=8.0))
            fault.install(fault.FaultInjector("grad.nonfinite:fail@1", 0))
            with mx.autograd.record():
                loss = net(x).sum()
            with amp.scale_loss(loss, tr) as scaled:
                scaled.backward()
            tr.step(4)
            assert s.loss_scale == 4.0
        finally:
            fault.install(None)
            if not was:
                tel.disable()
    _close(out[0], out[1])


def test_amp_refused_with_server_side_updates():
    net, tr = _dense(tmx, 1)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1}, kvstore="local",
                           update_on_kvstore=True)
    tamp.init_trainer(tr)
    with tmx.autograd.record():
        loss = net(tmx.nd.array(np.ones((2, 3), np.float32), ctx=CPU)).sum()
    with tamp.scale_loss(loss, tr) as scaled:
        scaled.backward()
    with pytest.raises(NotImplementedError, match="server-side updates"):
        tr.step(2)


# -- a float16 channels-last ResNet under the default scaler -----------------

def _thin_resnet(mx):
    from importlib import import_module

    resnet = import_module(mx.__name__ + ".gluon.model_zoo.vision.resnet")
    return resnet.ResNet(1, (2, 1), (8, 16, 32), True, classes=10,
                         layout="NHWC", prefix="amp_")


def test_float16_resnet_steps_match_jax(monkeypatch):
    """convert_block(net, "float16") of a thin NHWC bottleneck ResNet (two
    stages: projection and identity joins), SGD (momentum, wd,
    multi_precision) under the default scaler (2^16): the float16 loss
    overflows at that scale, so the first steps are skipped (the weights
    stay bit-equal) and halve it, as in JAX. The port with the fused
    epilogue (its plain float16 versions on the CPU) against JAX's
    unfused float16 chain: the same scale trail, skipped steps and
    dtypes, each step's loss at rtol 2e-2, and the float32 masters'
    movement within 0.1 in relative 2-norm (float16 gradients: at this
    size JAX's own float16 movement parts from its float32 one by more,
    0.12 in the largest entry of the stem's weight)."""
    rng = np.random.RandomState(0)
    x = rng.rand(8, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)
    jnet = _thin_resnet(jmx)
    jnet.initialize(jmx.init.Zero())
    jnet(jmx.nd.array(x))
    weights = {}
    for name, p in sorted(jnet.collect_params().items()):
        shape = p.data().shape
        if name.endswith(("running_var", "gamma")):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith(("running_mean", "beta", "bias")):
            a = 0.1 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        weights[name] = a.astype(np.float32)
        p.set_data(jmx.nd.array(weights[name]))
    tnet = _thin_resnet(tmx)
    tnet.initialize(tmx.init.Zero(), device="cpu")
    load_numpy_params(tnet, weights, prefix=jnet.prefix)
    from incubator_mxnet_tpu_torch.ops import epilogue as tepi

    runs = []
    for mx, amp, net, fused in ((tmx, tamp, tnet, "1"), (jmx, jamp, jnet,
                                                         "0")):
        monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", fused)
        amp.convert_block(net, "float16")
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9,
                               "wd": 1e-4, "multi_precision": True})
        s = amp.init_trainer(tr)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        xd, yd = _nd(mx, x).astype("float16"), _nd(mx, y)
        trail, losses, skipped = [], [], []
        rewrites = tepi.rewrites_applied
        for _ in range(4):
            with mx.autograd.record():
                loss = loss_fn(net(xd), yd)
            with amp.scale_loss(loss, tr) as scaled:
                scaled.backward()
            before = _weights(net)
            tr.step(8)
            skipped.append(all((a == b).all()
                               for a, b in zip(_weights(net), before)))
            trail.append(s.loss_scale)
            losses.append(float(loss.asnumpy().astype(np.float32).mean()))
        if mx is tmx:
            assert tepi.rewrites_applied > rewrites
        # the float32 masters' movement from the drawn weights
        states = tr._updater.states
        moved = {tr._params[i].name: states[i][1].asnumpy()
                 .astype(np.float32) - weights[tr._params[i].name]
                 for i in sorted(states) if isinstance(states[i], tuple)}
        runs.append(dict(trail=trail, skipped=skipped, losses=losses,
                         moved=moved,
                         dtypes=[np.dtype(p.data().dtype).name
                                 for p in net.collect_params().values()]))
    port, jax_ = runs
    for key in ("trail", "skipped", "dtypes"):
        assert port[key] == jax_[key], key
    assert port["trail"][:2] == [2.0 ** 15, 2.0 ** 14]  # two overflows
    assert port["skipped"][:3] == [True, True, False]
    assert {"float16", "float32"} <= set(port["dtypes"])
    np.testing.assert_allclose(port["losses"], jax_["losses"], rtol=2e-2)
    assert set(port["moved"]) == set(jax_["moved"]) and port["moved"]
    for name, want in jax_["moved"].items():
        if "conv" in name and name.endswith("bias"):
            continue  # a bias before a BatchNorm: its true gradient is 0
        err = np.linalg.norm(port["moved"][name] - want)
        assert err <= 0.1 * np.linalg.norm(want), (name, err)
