"""The port's `GluonTrainStep` surface against the JAX package's, on the
CPU, with the same seeded numpy inputs and the JAX nets' weights carried
to the port (by position: `set_data`): `compute_dtype`, `scan_steps` on a
float32 and on a bfloat16-cast net, `accum_steps`, remat and its
policies, `save_states` / `load_states` both ways, `memory_stats`,
`warmup`, `cost_stats`, `sync_params`, and the step statistics and memory
ledger the step feeds. The nets are the JAX tests' (`tests/test_gluon.py`)
two-layer Dense nets and `test_torch_resnet.py`'s thin NHWC ResNet.
Tolerances: losses and weights at rtol 1e-5 (float32), 2e-2 (bfloat16
compute), remat against plain at rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import fused as jfused
from incubator_mxnet_tpu import gluon, nd
from incubator_mxnet_tpu.gluon import nn as jnn
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import fused as tfused
from incubator_mxnet_tpu_torch import profiler as tprofiler
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.gluon import nn as tnn
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    ResNet as TResNet)
from incubator_mxnet_tpu_torch.ops import epilogue as tepi

SGD = dict(learning_rate=0.1, momentum=0.9)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: beside the suite's other workers torch's thread
    pool makes these small ops many times slower and takes their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dense(units, x, in_units=0, cast=None):
    """The JAX tests' Dense net, shapes resolved by a forward of x."""
    net = jnn.HybridSequential()
    net.add(jnn.Dense(units[0], activation="relu", in_units=in_units),
            jnn.Dense(units[1]))
    net.initialize(mx.init.Xavier())
    net(nd.array(x))
    if cast:
        net.cast(cast)
    return net


def _values(net):
    """The JAX net's parameter values, in order (a Dense net's children
    take their names from per-process counters, so nets are matched by
    position)."""
    return [np.asarray(p.data()._data.astype("float32"))
            for p in net.collect_params().values()]


def _load(net, values):
    for p, v in zip(net.collect_params().values(), values):
        p.set_data(torch.tensor(v))


def _port_dense(units, values, x, cast=None):
    net = tnn.HybridSequential()
    net.add(tnn.Dense(units[0], activation="relu"), tnn.Dense(units[1]))
    net.initialize(tmx.init.Xavier(), device="cpu")
    net(torch.from_numpy(x))
    _load(net, values)
    if cast:
        net.cast(cast)
    return net


def _jax_step(net, **kw):
    L = gluon.loss.SoftmaxCrossEntropyLoss()
    opt = kw.pop("opt", None) or mx.optimizer.SGD(**SGD)
    return jfused.GluonTrainStep(net, lambda n, a, b: L(n(a), b), opt, **kw)


def _port_step(net, **kw):
    L = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    opt = kw.pop("opt", None) or tmx.optimizer.SGD(**SGD)
    return tfused.GluonTrainStep(net, lambda n, a, b: L(n(a), b), opt,
                                 device="cpu", **kw)


def _port_values(net):
    return [p.tensor().detach().float().numpy()
            for p in net.collect_params().values()]


def test_compute_dtype_matches_jax_with_float32_masters():
    """JAX's test_train_step_compute_dtype_mixed_precision setup: five
    steps with bfloat16 compute against float32 masters."""
    rng = np.random.RandomState(1)
    x = rng.rand(8, 10).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    jnet = _jax_dense((16, 4), x)
    net = _port_dense((16, 4), _values(jnet), x)
    jstep = _jax_step(jnet, compute_dtype="bfloat16")
    step = _port_step(net, compute_dtype="bfloat16")
    want = [float(jstep(nd.array(x), nd.array(y)).asscalar())
            for _ in range(5)]
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]
    assert all(w.dtype == torch.float32 for w in step.weights)
    assert all(s.dtype == torch.float32 for s in step.states)
    assert step.compute_dtype == torch.bfloat16


def test_scan_steps_on_a_bfloat16_cast_net_matches_jax():
    """JAX's test_scan_steps_bf16_cast_net setup: the same float32 weights
    cast to bfloat16 on both sides, three scans of three steps."""
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    xs = rng.rand(3, 6, 5).astype(np.float32)
    ys = rng.randint(0, 3, size=(3, 6)).astype(np.float32)
    jnet = _jax_dense((8, 3), xs[0])
    net = _port_dense((8, 3), _values(jnet), xs[0], cast="bfloat16")
    jnet.cast("bfloat16")
    jstep, step = _jax_step(jnet), _port_step(net)
    jxs = nd.from_jax(jnp.asarray(xs, jnp.bfloat16))
    txs = torch.from_numpy(xs).bfloat16()
    for _ in range(3):
        want = jstep.scan_steps(jxs, nd.array(ys)).asnumpy().astype(
            np.float32)
        got = step.scan_steps(txs, torch.from_numpy(ys))
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2)
    assert all(p.tensor().dtype == torch.bfloat16
               for p in net.collect_params().values())
    assert all(s.dtype == torch.bfloat16 for s in step.states)
    assert step._n == 9 and step.opt.num_update == 9


def _scan_data():
    rng = np.random.RandomState(0)
    return (rng.rand(4, 6, 5).astype(np.float32),
            rng.randint(0, 3, size=(4, 6)).astype(np.float32))


def test_scan_steps_equal_single_steps_and_jax():
    """JAX's test_scan_steps_matches_sequential setup: a scan of 4 steps
    equals 4 single steps (port) and JAX's scan, losses and weights."""
    xs, ys = _scan_data()
    jnet = _jax_dense((8, 3), xs[0])
    arrays = _values(jnet)
    jstep = _jax_step(jnet)
    want = jstep.scan_steps(nd.array(xs), nd.array(ys)).asnumpy()
    jstep.sync_params()
    seq_net = _port_dense((8, 3), arrays, xs[0])
    seq = _port_step(seq_net)
    seq_losses = [float(seq(torch.from_numpy(xs[k]), torch.from_numpy(ys[k])))
                  for k in range(4)]
    net = _port_dense((8, 3), arrays, xs[0])
    step = _port_step(net)
    got = step.scan_steps(torch.from_numpy(xs), torch.from_numpy(ys))
    np.testing.assert_allclose(got.numpy(), seq_losses, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    for a, b, c in zip(_port_values(net), _port_values(seq_net),
                       _values(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)
    assert np.isfinite(float(step(torch.from_numpy(xs[0]),
                                  torch.from_numpy(ys[0]))))


def _bn_scan_step():
    """A Dense -> BatchNorm -> Dense net's step after one step and one
    scan, so that its momenta and running stats are not at their
    initial values, and a scan's stacked batches."""
    xs, ys = (torch.from_numpy(a) for a in _scan_data())
    net = tnn.HybridSequential()
    net.add(tnn.Dense(8, activation="relu"), tnn.BatchNorm(), tnn.Dense(3))
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(0)), device="cpu")
    with torch.no_grad():
        net(xs[0])
    step = _port_step(net)
    step(xs[0], ys[0])
    step.scan_steps(xs, ys)  # creates the scan's site
    return step, xs, ys


def _state(step):
    return [t.detach().clone() for t in step._mutable()]


def _set_state(step, state):
    with torch.no_grad():
        for t, v in zip(step._mutable(), state):
            t.copy_(v)


def _scan_warm_up(step, xs):
    """What a scan's first call on CUDA runs before its capture: the
    site's warm-up, the K steps on all-zero inputs (lr 0, zero batches,
    which still decay the momenta and move the running stats)."""
    k = xs.shape[0]
    step._scan._warm_up([torch.zeros_like(xs),
                         torch.zeros((k, xs.shape[1])), torch.zeros(k),
                         torch.zeros(k)])


def _assert_same(a, b):
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_scan_first_call_equals_a_later_call_from_the_same_state():
    """Nothing of a scan's first call on CUDA (its warm-up, then the
    capture, which runs nothing) leaves a trace: the warm-up puts the
    weights, momenta and running stats back bit for bit, and a scan after
    it gives the losses and state of a scan from the same state without
    it."""
    step, xs, ys = _bn_scan_step()
    start = _state(step)
    _scan_warm_up(step, xs)
    _assert_same(_state(step), start)
    first = step.scan_steps(xs, ys)
    after_first = _state(step)
    _set_state(step, start)
    second = step.scan_steps(xs, ys)
    torch.testing.assert_close(second, first, rtol=0, atol=0)
    _assert_same(_state(step), after_first)


def test_a_warm_up_without_its_state_restore_would_be_caught():
    """The check above can fail: the same warm-up with the site's state
    restore taken away changes the momenta and the running stats, and the
    scan after it ends in another state."""
    step, xs, ys = _bn_scan_step()
    start = _state(step)
    step.scan_steps(xs, ys)
    honest = _state(step)
    _set_state(step, start)
    step._scan.state = None
    _scan_warm_up(step, xs)
    moved = [not torch.equal(a, b) for a, b in zip(_state(step), start)]
    step.scan_steps(xs, ys)
    ended = [not torch.equal(a, b) for a, b in zip(_state(step), honest)]
    n_w = len(step.weights)
    n_aux = len(step.aux)
    assert any(moved[n_w + n_aux:])  # the momenta
    assert any(moved[n_w:n_w + n_aux])  # the running stats
    assert all(ended[n_w:])


def test_accum_steps_equal_a_big_batch_step_and_jax():
    """JAX's test_accum_steps_matches_big_batch setup: 2 micro-batches of
    4 at rescale 0.5 equal one batch of 8 at rescale 1, three times."""
    rng = np.random.RandomState(3)
    X = rng.rand(8, 6).astype(np.float32)
    Y = rng.randint(0, 3, 8).astype(np.float32)
    jnet = _jax_dense((16, 3), X, in_units=6)
    arrays = _values(jnet)
    jacc = _jax_step(jnet, opt=mx.optimizer.SGD(rescale_grad=0.5, **SGD))
    acc_net = _port_dense((16, 3), arrays, X)
    acc = _port_step(acc_net, opt=tmx.optimizer.SGD(rescale_grad=0.5, **SGD))
    big_net = _port_dense((16, 3), arrays, X)
    big = _port_step(big_net)
    for _ in range(3):
        want = float(jacc.accum_steps(nd.array(X.reshape(2, 4, 6)),
                                      nd.array(Y.reshape(2, 4))).asscalar())
        got = float(acc.accum_steps(torch.from_numpy(X.reshape(2, 4, 6)),
                                    torch.from_numpy(Y.reshape(2, 4))))
        whole = float(big(torch.from_numpy(X), torch.from_numpy(Y)))
        np.testing.assert_allclose(got, whole, rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert acc._n == 3 and acc.opt.num_update == 3
    jacc.sync_params()
    for a, b, c in zip(_port_values(acc_net), _port_values(big_net),
                       _values(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


# -- remat ---------------------------------------------------------------

RESNET_ARGS = (1, (1, 1, 1, 1), (16, 32, 64, 128, 256))
RESNET_KW = dict(bottleneck=True, classes=10, layout="NHWC")
REMATS = {"remat=True": dict(remat=True),
          **{p: dict(remat_policy=p) for p in (
              "convs", "dots", "dots_no_batch", "offload", "nothing",
              "everything", "dots_with_no_batch_dims_saveable")}}


def _resnet_batch():
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 10, 4).astype(np.float32)))


def _resnet_run(**kw):
    """Two steps of the thin NHWC ResNet with the fused epilogue on: the
    losses, the running stats after step 1, every parameter after step
    2, and the fused calls of step 2."""
    x, y = _resnet_batch()
    net = TResNet(*RESNET_ARGS, **RESNET_KW)
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(0)), device="cpu")
    with torch.no_grad():
        net(x[:2])
    step = _port_step(net, opt=tmx.optimizer.SGD(
        learning_rate=0.05, momentum=0.9, wd=1e-4, rescale_grad=0.25), **kw)
    losses = [float(step(x, y))]
    stats = {n[len(net.prefix):]: p.tensor().clone()
             for n, p in net.collect_params().items()
             if p.grad_req == "null"}
    tepi.rewrites_applied = 0
    losses.append(float(step(x, y)))
    return losses, stats, _port_values(net), tepi.rewrites_applied


@pytest.fixture(scope="module")
def plain_resnet():
    mp = pytest.MonkeyPatch()
    mp.setenv("MXTPU_FUSED_EPILOGUE", "1")
    try:
        yield _resnet_run()
    finally:
        mp.undo()


@pytest.mark.parametrize("name", list(REMATS))
def test_remat_equals_plain_and_moves_running_stats_once(name, plain_resnet,
                                                         monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", "1")
    want_losses, want_stats, want_values, want_calls = plain_resnet
    losses, stats, values, calls = _resnet_run(**REMATS[name])
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    for k, v in want_stats.items():
        # written once per step: a second write would move them again
        np.testing.assert_allclose(stats[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=0, err_msg=k)
    for a, b in zip(values, want_values):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert want_calls == 13  # the stem + 3 per unit x 4 units, fused
    # a remat step runs the fused epilogue in the forward, again in each
    # unit's own recompute, and in the whole forward's recompute as far as
    # the backward needs it (PyTorch stops a recompute early once every
    # tensor it must supply exists)
    if name == "everything":
        assert calls == want_calls
    else:
        assert 2 * want_calls < calls <= 3 * want_calls


def test_running_stats_move_once_against_one_plain_forward(monkeypatch):
    """The stem's running mean after one remat step is momentum * before
    + (1 - momentum) * the batch mean of the stem's input, exactly once."""
    monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", "1")
    x, y = _resnet_batch()
    net = TResNet(*RESNET_ARGS, **RESNET_KW)
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(0)), device="cpu")
    with torch.no_grad():
        net(x[:2])
    stem_conv = net.features[0]
    mean = net.collect_params()[net.prefix + "batchnorm0_running_mean"]
    before = mean.tensor().clone()
    with torch.no_grad():
        batch_mean = stem_conv(x).mean(dim=(0, 1, 2))
    step = _port_step(net, remat_policy="nothing")
    step(x, y)
    np.testing.assert_allclose(mean.tensor().numpy(),
                               (0.9 * before + 0.1 * batch_mean).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["convs", "dots", "dots_no_batch",
                                  "offload", "nothing", "everything",
                                  "dots_saveable", "nothing_saveable",
                                  "offload_dot_with_no_batch_dims"])
def test_resolve_remat_policy_accepts_the_jax_names(name):
    assert jfused.resolve_remat_policy(name) is not None
    policy = tfused.resolve_remat_policy(name)
    assert policy.name == tfused._REMAT_POLICY_ALIASES.get(name, name)


def test_resolve_remat_policy_rejects_unknown_names_and_reads_the_knob(
        monkeypatch):
    assert tfused.resolve_remat_policy("") is None
    for pkg in (jfused, tfused):
        with pytest.raises(ValueError, match="unknown remat policy"):
            pkg.resolve_remat_policy("no_such_policy")
    with pytest.raises(ValueError, match="unknown remat policy"):
        _port_step(tnn.Dense(2), remat_policy="bogus")
    monkeypatch.setenv("MXTPU_REMAT_POLICY", "convs")
    step = _port_step(tnn.Dense(2))
    assert step.remat and step.remat_policy == "convs"
    step = _port_step(tnn.Dense(2), remat_policy="")
    assert not step.remat and step.remat_policy == ""


# -- the state surface ---------------------------------------------------

def _resume_data():
    rng = np.random.RandomState(5)
    return (rng.rand(8, 6).astype(np.float32),
            rng.randint(0, 3, 8).astype(np.float32))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_and_load_states_resume_across_packages(direction, tmp_path):
    """JAX's test_fused_step_state_checkpoint_resume with SGD (the port's
    optimizer): two steps, save_states, a fresh step of the other package
    loads the file before its first step (the pending path) and the
    weights, and both continue two steps alike at rtol 1e-5."""
    X, Y = _resume_data()
    fst = str(tmp_path / "opt.states")
    jnet = _jax_dense((16, 3), X, in_units=6)
    jstep = _jax_step(jnet)
    net = _port_dense((16, 3), _values(jnet), X)
    step = _port_step(net)
    jx, jy = nd.array(X), nd.array(Y)
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    if direction == "jax_to_port":
        for _ in range(2):
            jstep(jx, jy)
        jstep.save_states(fst)
        jstep.sync_params()
        _load(net, _values(jnet))
        step.load_states(fst)
        assert step._pending_states is not None and step._n == 2
        got = [float(step(tx, ty)) for _ in range(2)]
        want = [float(jstep(jx, jy).asscalar()) for _ in range(2)]
    else:
        for _ in range(2):
            step(tx, ty)
        step.save_states(fst)
        fresh = _jax_dense((16, 3), X, in_units=6)
        for p, v in zip(fresh.collect_params().values(), _port_values(net)):
            p.set_data(nd.array(v))
        jresume = _jax_step(fresh)
        jresume.load_states(fst)
        want = [float(jresume(jx, jy).asscalar()) for _ in range(2)]
        got = [float(step(tx, ty)) for _ in range(2)]
        assert jresume._n == 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert step._n == 4 and step.opt.num_update == 4


def test_save_states_stores_bfloat16_states_as_float32(tmp_path):
    import pickle

    X, Y = _resume_data()
    net = _port_dense((16, 3), _values(_jax_dense((16, 3), X, in_units=6)),
                      X, cast="bfloat16")
    step = _port_step(net)
    step(torch.from_numpy(X).bfloat16(), torch.from_numpy(Y))
    fst = str(tmp_path / "opt.states")
    step.save_states(fst)
    with open(fst, "rb") as f:
        d = pickle.load(f)
    assert d["n"] == 1 and all(a.dtype == np.float32 for a in d["states"])
    moms = [s.clone() for s in step.states]
    for s in step.states:
        s.zero_()
    step.load_states(fst)
    for a, b in zip(step.states, moms):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_a_cast_before_the_first_step_is_honoured():
    """The step collects its weights at its first call: a cast made after
    the step was built, before that call, is the one it trains."""
    X, Y = _resume_data()
    net = _port_dense((16, 3), _values(_jax_dense((16, 3), X, in_units=6)),
                      X)
    step = _port_step(net)
    net.cast("bfloat16")
    step(torch.from_numpy(X).bfloat16(), torch.from_numpy(Y))
    params = [p for p in net.collect_params().values()]
    assert all(w is p.tensor() for w, p in zip(step.weights, params))
    assert all(w.dtype == torch.bfloat16 for w in step.weights)


def test_memory_stats_warmup_cost_stats_and_sync_params():
    X, Y = _resume_data()
    jnet = _jax_dense((16, 3), X, in_units=6)
    net = _port_dense((16, 3), _values(jnet), X)
    step = _port_step(net)
    jstats = _jax_step(jnet).memory_stats(nd.array(X), nd.array(Y))
    before = _port_values(net)
    stats = step.memory_stats(torch.from_numpy(X), torch.from_numpy(Y),
                              name="dense_step")
    assert set(stats) == set(jstats)
    params = sum(v.size * 4 for v in before)
    assert stats["argument_bytes"] == 2 * params + X.nbytes + Y.nbytes
    assert stats["alias_bytes"] == 2 * params
    assert stats["peak_bytes"] == (stats["argument_bytes"]
                                   + stats["output_bytes"]
                                   + stats["temp_bytes"]
                                   - stats["alias_bytes"])
    assert "dense_step" in tprofiler.dumps_memory()
    for a, b in zip(_port_values(net), before):  # nothing was written
        np.testing.assert_array_equal(a, b)
    assert all(not s.any() for s in step.states)
    assert step.warmup(X, Y) == "disabled" and step._n == 0
    assert step.cost_stats(X, Y) == {}
    assert step.sync_params() is None


def test_mesh_sharding_and_init_on_device_stay_refused():
    for kw in (dict(mesh=object()), dict(shard_policy="zero1"),
               dict(shard_optimizer_states=True),
               dict(init_on_device=True)):
        with pytest.raises(NotImplementedError):
            _port_step(tnn.Dense(2), **kw)


@pytest.fixture
def telemetry_on(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    ttel.refresh_from_env()
    for mod in (ttel.REGISTRY, ttel.compilereg, ttel.stepstats,
                ttel.ledger):
        mod.reset()
    yield
    monkeypatch.delenv("MXNET_TELEMETRY")
    ttel.refresh_from_env()
    for mod in (ttel.REGISTRY, ttel.compilereg, ttel.stepstats,
                ttel.ledger):
        mod.reset()


def test_step_statistics_ledger_and_registry(telemetry_on):
    """Phases h2d and dispatch and one step_end per call; the momenta
    tracked as optimizer_state; the step, scan and accumulation each
    registered once per signature under the JAX names."""
    X, Y = _resume_data()
    net = _port_dense((16, 3), _values(_jax_dense((16, 3), X, in_units=6)),
                      X)
    step = _port_step(net)
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    for _ in range(3):
        step(tx, ty)
    snap = ttel.stepstats.snapshot()
    assert snap["steps"] == 3 and {"h2d", "dispatch"} <= set(snap["phases"])
    assert ttel.ledger.live_bytes("optimizer_state") == sum(
        s.numel() * 4 for s in step.states)
    for _ in range(2):
        step.scan_steps(tx[None].repeat(2, 1, 1), ty[None].repeat(2, 1))
        step.accum_steps(tx.reshape(2, 4, 6), ty.reshape(2, 4))
    reg = ttel.compilereg.snapshot()
    assert {fn: reg[fn]["signatures"] for fn in reg} == {
        "GluonTrainStep.step": 1, "GluonTrainStep.scan": 1,
        "GluonTrainStep.accum": 1}
    assert ttel.stepstats.snapshot()["steps"] == 3
