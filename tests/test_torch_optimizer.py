"""The port's optimizers against the JAX package's, on the CPU.

Every case of JAX's `_FUSED_CASES` (`tests/test_optimizer.py`: 15
optimizers, SGD and RMSProp twice) makes 3 updates of one seeded (4, 3)
weight through the eager `update` and the fused path in both packages,
held at rtol 1e-5, atol 1e-6 (`test_fused_update_matches_eager`'s
tolerance). Then the `Updater` with tuple states (`Trainer("adam")`, a
bare updater, pickles across both packages), multi-precision SGD on
bfloat16 (masters at rtol 1e-5, atol 1e-6, weights within one bfloat16
ulp), stochastic rounding (unbiased in both packages; the port's eager,
aggregated and fused paths bit-equal), SGLD's noise, the registry of 16
names and a user's optimizer through the generic fused path.
"""
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu_torch import optimizer as topt

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6
NAMES = ["sgd", "nag", "sgld", "signum", "ftml", "dcasgd", "lbsgd", "adam",
         "adagrad", "rmsprop", "adadelta", "ftrl", "adamax", "nadam",
         "adamw", "test"]
FUSED_CASES = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("sgd", dict(learning_rate=0.1)),
    ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("signum", dict(learning_rate=0.1, momentum=0.9, wd_lh=0.01)),
    ("ftml", dict(learning_rate=0.1, wd=0.01)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("lbsgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("adam", dict(learning_rate=0.1, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.1, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.1, centered=True)),
    ("adadelta", dict(wd=0.01)),
    ("ftrl", dict(learning_rate=0.1, lamda1=0.01)),
    ("adamax", dict(learning_rate=0.1, wd=0.01)),
    ("nadam", dict(learning_rate=0.1, wd=0.01)),
    ("adamw", dict(learning_rate=0.1, wd=0.01)),
    ("test", dict(rescale_grad=0.5)),
]


def _data():
    rng = np.random.RandomState(42)
    w0 = rng.randn(4, 3).astype(np.float32)
    return w0, [rng.randn(4, 3).astype(np.float32) for _ in range(3)]


def _jax_runs(name, kw, w0, grads):
    from incubator_mxnet_tpu.fused import GluonTrainStep

    o = jopt.create(name, **kw)
    w = jmx.nd.array(w0.copy())
    st = o.create_state(0, w)
    for g in grads:
        o.update(0, w, jmx.nd.array(g), st)
    o2 = jopt.create(name, **kw)
    make = getattr(o2, "create_fused_state", o2.create_state)
    sf = GluonTrainStep._state_data(make(0, jmx.nd.array(w0.copy())))
    wf = jnp.asarray(w0.copy())
    for t, g in enumerate(grads, 1):
        wf, sf = o2.fused_update("p0", wf, jnp.asarray(g), sf, o2.lr,
                                 t=float(t))
    return w.asnumpy(), np.asarray(wf)


def _port_runs(name, kw, w0, grads):
    o = topt.create(name, **kw)
    w = tmx.nd.array(w0.copy(), ctx=CPU)
    st = o.create_state(0, w)
    for g in grads:
        o.update(0, w, tmx.nd.array(g, ctx=CPU), st)
    o2 = topt.create(name, **kw)
    wf = torch.from_numpy(w0.copy())
    sf = o2.create_fused_state(0, wf)
    for t, g in enumerate(grads, 1):
        o2.fused_update("p0", wf, torch.from_numpy(g), sf, o2.lr,
                        t=torch.tensor(float(t)))
    return w.asnumpy(), wf.numpy()


@pytest.mark.parametrize("name,kwargs", FUSED_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FUSED_CASES)])
def test_optimizer_matches_jax_eager_and_fused(name, kwargs):
    w0, grads = _data()
    je, jf = _jax_runs(name, kwargs, w0, grads)
    te, tf = _port_runs(name, kwargs, w0, grads)
    np.testing.assert_allclose(te, je, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=ATOL)
    if name != "nadam":  # its fused schedule is per parameter, as in JAX
        np.testing.assert_allclose(tf, te, rtol=RTOL, atol=ATOL)


def test_create_gives_the_port_class_for_every_registered_name():
    assert sorted(topt._REGISTRY) == sorted(jopt._REGISTRY) == \
        sorted(NAMES)
    for name in NAMES:
        o = topt.create(name)
        assert type(o).__name__ == type(jopt.create(name)).__name__
        assert type(o).__module__ == "incubator_mxnet_tpu_torch.optimizer"
    assert not topt.Nadam.fused_matches_eager
    assert not topt.SGLD.fused_matches_eager
    assert topt.Adam.fused_matches_eager


# -- the Updater with tuple states ---------------------------------------------

def _dense_adam_step(mx, ctx=None):
    net = mx.gluon.nn.Dense(2, in_units=3)
    kw = {} if ctx is None else {"ctx": ctx}
    net.initialize(mx.init.One(), **kw)
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.1})
    x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3) / 10,
                    **kw)
    for _ in range(2):
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(4)
    return net, tr


def test_trainer_adam_steps_with_tuple_states():
    """The repaired fault: `Trainer(params, "adam")` on the port crashed
    at its first step (the Updater wrapped Adam's (mean, var) tuple in
    one NDArray)."""
    tnet, ttr = _dense_adam_step(tmx, CPU)
    jnet, jtr = _dense_adam_step(jmx)
    for tp, jp in zip(tnet.collect_params().values(),
                      jnet.collect_params().values()):
        np.testing.assert_allclose(tp.data().asnumpy(), jp.data().asnumpy(),
                                   rtol=RTOL, atol=ATOL)
    ts = pickle.loads(ttr._updater.get_states())
    js = pickle.loads(jtr._updater.get_states())
    assert sorted(ts) == sorted(js)
    for k in js:
        assert isinstance(ts[k], tuple) and len(ts[k]) == 2
        for a, b in zip(ts[k], js[k]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_bare_updater_takes_tuple_states_and_pickles_as_jax():
    """Two updates of w = 1 by g = 1 at lr 0.1 (JAX's values); get_states /
    set_states across both packages, both ways."""
    upd = topt.get_updater(topt.create("adam", learning_rate=0.1))
    w = tmx.nd.array(np.ones(3, np.float32), ctx=CPU)
    g = tmx.nd.array(np.ones(3, np.float32), ctx=CPU)
    upd(0, g, w)
    upd(0, g, w)
    np.testing.assert_allclose(w.asnumpy(), np.full(3, 0.8000001,
                                                    np.float32), rtol=1e-7)
    mean, var = pickle.loads(upd.get_states())[0]
    np.testing.assert_allclose(mean, np.full(3, 0.19), rtol=1e-6)
    np.testing.assert_allclose(var, np.full(3, 0.001999), rtol=1e-6)

    jupd = jopt.get_updater(jopt.create("adam", learning_rate=0.1))
    jw, jg = jmx.nd.array(np.ones(3, np.float32)), jmx.nd.ones((3,))
    jupd(0, jg, jw)
    jupd(0, jg, jw)
    np.testing.assert_array_equal(w.asnumpy(), jw.asnumpy())
    jupd.set_states(upd.get_states())  # the port's file in JAX
    jupd(0, jg, jw)
    upd2 = topt.get_updater(topt.create("adam", learning_rate=0.1))
    upd2.set_states(jupd.get_states())  # and JAX's in the port
    for a, b in zip(upd2.states[0], jupd.states[0]):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL)
    # the loaded tuple keeps updating
    upd2.optimizer._index_update_count[0] = 1
    w2 = tmx.nd.array(np.ones(3, np.float32), ctx=CPU)
    upd2(0, g, w2)
    assert np.isfinite(w2.asnumpy()).all()


# -- multi-precision SGD on bfloat16 -------------------------------------------

def _bf16_ulp(x):
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_multi_precision_sgd_on_bfloat16(momentum):
    """Masters within rtol 1e-5, atol 1e-6 of JAX's; weights bfloat16,
    within one bfloat16 ulp; the fused path equal to the eager one."""
    rng = np.random.RandomState(1)
    w0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=0.05, momentum=momentum, wd=1e-4,
              multi_precision=True, rescale_grad=0.5)
    jo = jopt.SGD(**kw)
    jw = jmx.nd.array(w0).astype("bfloat16")
    js = jo.create_state_multi_precision(0, jw)
    to = topt.SGD(**kw)
    tw = tmx.nd.array(w0, ctx=CPU).astype("bfloat16")
    ts = to.create_state_multi_precision(0, tw)
    fo = topt.SGD(**kw)
    fw = torch.from_numpy(w0).bfloat16()
    fs = fo.create_fused_state(0, fw)
    assert isinstance(ts, tuple) and ts[1].dtype == np.float32
    for g in grads:
        jo.update_multi_precision(0, jw, jmx.nd.array(g).astype("bfloat16"),
                                  js)
        to.update_multi_precision(0, tw, tmx.nd.array(g, ctx=CPU)
                                  .astype("bfloat16"), ts)
        fo.fused_update("w", fw, torch.from_numpy(g).bfloat16(), fs,
                        torch.tensor(0.05))
    np.testing.assert_allclose(ts[1].asnumpy(), js[1].asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(fs[1].numpy(), ts[1].asnumpy())
    assert tw.dtype == jw.dtype and fw.dtype == torch.bfloat16
    jwf = jw.asnumpy().astype(np.float32)
    assert (np.abs(tw.asnumpy() - jwf) <= _bf16_ulp(jwf)).all()
    np.testing.assert_array_equal(fw.float().numpy(), tw.asnumpy())


# -- stochastic rounding -------------------------------------------------------

def _sr_vector(n=512):
    """float32 values none of which is a bfloat16 value."""
    rng = np.random.RandomState(5)
    x = rng.randn(n).astype(np.float32)
    return x + np.spacing(x) * 3


def test_stochastic_rounding_is_unbiased_in_both_packages():
    """4096 draws of each of 512 fixed float32 values: the mean rounding
    error, in bfloat16 ulps, within 4 sigma of 0 (sigma of a Bernoulli
    draw per value), in both packages."""
    import jax

    x = _sr_vector()
    ulp = _bf16_ulp(x)
    lo = x.astype(jnp.bfloat16).astype(np.float32)  # nearest, not floor
    frac = (x - np.where(lo > x, lo - ulp, lo)) / ulp
    sigma = np.sqrt((frac * (1 - frac)).mean() / (4096 * x.size))
    tiled = np.tile(x, 4096)
    bits = topt._hash_bits(0, 7, ["w"], [tiled.size], "cpu")
    port = topt.stochastic_round_bf16(torch.from_numpy(tiled), bits)
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    jround = jax.jit(jax.vmap(lambda k: jopt._stochastic_round_bf16(
        jnp.asarray(x), k)))
    jaxr = np.asarray(jround(keys).astype(jnp.float32)).reshape(-1)
    for got in (port.float().numpy(), jaxr):
        err = ((got - tiled) / np.tile(ulp, 4096)).mean()
        assert abs(err) < 4 * sigma, (err, sigma)
        assert set(np.unique(np.abs(got - tiled) < np.tile(ulp, 4096))) \
            == {True}


def _sr_net(seed=0):
    """The same parameter names each time: they key the rounding bits."""
    net = tmx.gluon.nn.Sequential(prefix="sr_")
    net.add(tmx.gluon.nn.Dense(16, in_units=8, prefix="sr_a_"),
            tmx.gluon.nn.Dense(4, in_units=16, prefix="sr_b_"))
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(seed)), ctx=CPU)
    net.cast("bfloat16")
    return net


def test_stochastic_rounding_paths_are_bit_equal(monkeypatch):
    """MXTPU_STOCHASTIC_ROUNDING: float32 momenta and no master; the
    per-parameter Trainer, the aggregated Trainer and `fused_updates`
    give the same bits over 3 steps of the same gradients."""
    monkeypatch.setenv("MXTPU_STOCHASTIC_ROUNDING", "1")
    rng = np.random.RandomState(3)
    shapes = [p.shape for p in _sr_net().collect_params().values()]
    grads = [[torch.from_numpy(rng.randn(*s).astype(np.float32)).bfloat16()
              for s in shapes] for _ in range(3)]
    kw = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
              multi_precision=True)
    finals = []
    for knob in ("0", "4096"):
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", knob)
        net = _sr_net()
        params = list(net.collect_params().values())
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd", kw)
        for gs in grads:
            for p, g in zip(params, gs):
                p.grad()._data.copy_(g)
            tr.step(1)
        st = tr._updater.states[0]
        assert isinstance(st, tmx.nd.NDArray) and st.dtype == np.float32
        finals.append([p.data()._data.clone() for p in params])
    net = _sr_net()
    params = list(net.collect_params().values())
    opt = topt.SGD(**kw)
    names = [p.name for p in params]
    ws = [p.tensor() for p in params]
    states = [opt.create_fused_state(i, w) for i, w in enumerate(ws)]
    for t, gs in enumerate(grads, 1):
        opt.fused_updates(names, ws, gs, states, torch.tensor(0.05),
                          t=torch.tensor(float(t)))
    finals.append([w.detach().clone() for w in ws])
    for a, b, c in zip(*finals):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b) and torch.equal(a, c)


def test_sgld_noise_has_the_langevin_moments():
    """SGLD with zero gradients: w moves by noise of variance lr, fused
    (hash) and eager (global random state) alike; JAX's fused noise is
    finite and differs per step."""
    n, lr = 20000, 0.04
    o = topt.SGLD(learning_rate=lr)
    w = torch.zeros(n)
    o.fused_update("p", w, torch.zeros(n), None, lr, t=torch.tensor(1.0))
    w_eager = tmx.nd.zeros((n,), ctx=CPU)
    o.update(0, w_eager, tmx.nd.zeros((n,), ctx=CPU), None)
    for got in (w.numpy(), w_eager.asnumpy()):
        assert np.isfinite(got).all()
        assert abs(got.mean()) < 5 * np.sqrt(lr / n)
        assert abs(got.std() - np.sqrt(lr)) < 0.03 * np.sqrt(lr)
    w2 = torch.zeros(n)
    o.fused_update("p", w2, torch.zeros(n), None, lr, t=torch.tensor(2.0))
    assert not torch.equal(w, w2)
    jo = jopt.SGLD(learning_rate=lr)
    j1, _ = jo.fused_update("p", jnp.zeros(8), jnp.zeros(8), None, lr,
                            t=1.0)
    assert np.isfinite(np.asarray(j1)).all()


def test_generic_fused_fallback_for_a_users_optimizer():
    """An optimizer that defines only `update` trains through
    `GluonTrainStep` (with a warning) and the Trainer's per-parameter
    path."""
    class MyOpt(topt.Optimizer):
        def update(self, index, weight, grad, state):
            weight._data = weight._data - self.lr * grad._data

    net = tmx.gluon.nn.Dense(1, in_units=4)
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(0)), ctx=CPU)
    L = tmx.gluon.loss.L2Loss()
    x = torch.from_numpy(np.random.RandomState(0).rand(16, 4)
                         .astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(1).rand(16, 1)
                         .astype(np.float32))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        step = tmx.fused.GluonTrainStep(net, lambda n, a, b: L(n(a), b),
                                        MyOpt(learning_rate=0.5),
                                        device="cpu")
        losses = [float(step(x, y)) for _ in range(20)]
    assert any("fused_update" in str(w.message) for w in rec)
    assert losses[-1] < losses[0]
    w = net.weight.data()
    before = w.asnumpy().copy()
    tr = tmx.gluon.Trainer(net.collect_params(), MyOpt(learning_rate=0.5))
    with tmx.autograd.record():
        loss = L(net(tmx.nd.array(x.numpy(), ctx=CPU)),
                 tmx.nd.array(y.numpy(), ctx=CPU)).mean()
    loss.backward()
    tr.step(1)
    assert net.weight.data() is w and not np.array_equal(w.asnumpy(),
                                                         before)


def _tiny(prefix):
    net = tmx.gluon.nn.Sequential(prefix=prefix)
    net.add(tmx.gluon.nn.Dense(6, in_units=4, prefix=prefix + "a_"),
            tmx.gluon.nn.Dense(2, in_units=6, prefix=prefix + "b_"))
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(3)), ctx=CPU)
    return net


STEP_CASES = {
    "adam": (dict(learning_rate=0.01), None, False),
    "nadam": (dict(learning_rate=0.01), None, False),
    "sgd_mp": (dict(learning_rate=0.1, momentum=0.9,
                    multi_precision=True), "bfloat16", False),
    "sgd_sr": (dict(learning_rate=0.1, momentum=0.9,
                    multi_precision=True), "bfloat16", True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_runs_every_state_layout(case, monkeypatch):
    """`GluonTrainStep` with tuple, multi-precision and stochastic-
    rounding states: `scan_steps` of 2 equals 2 eager steps bit for bit
    (the CPU runs the scan's steps eagerly, through the same update),
    `accum_steps` updates once, and the states keep their layout and
    dtypes (float32 masters and momenta on a bfloat16 net)."""
    kw, cast, sr = STEP_CASES[case]
    if sr:
        monkeypatch.setenv("MXTPU_STOCHASTIC_ROUNDING", "1")
    name = "sgd" if case.startswith("sgd") else case
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(2, 8, 4).astype(np.float32))
    ys = torch.from_numpy(rng.randn(2, 8, 2).astype(np.float32))
    L = tmx.gluon.loss.L2Loss()
    runs = []
    for scan in (False, True):
        net = _tiny("st_")
        if cast:
            net.cast(cast)
        step = tmx.fused.GluonTrainStep(
            net, lambda n, a, b: L(n(a), b), topt.create(name, **kw),
            device="cpu")
        xx = xs.to(getattr(torch, cast)) if cast else xs
        losses = (step.scan_steps(xx, ys) if scan else
                  torch.stack([step(xx[k], ys[k]) for k in range(2)]))
        runs.append((losses, [w.clone() for w in step.weights],
                     step.states))
    (l0, w0, s0), (l1, w1, s1) = runs
    assert torch.equal(l0, l1) and torch.isfinite(l0).all()
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))
    state = s0[0]
    if case == "sgd_mp":
        assert isinstance(state, tuple) and state[1].dtype == torch.float32
        assert state[0].dtype == torch.float32
    elif case == "sgd_sr":
        assert torch.is_tensor(state) and state.dtype == torch.float32
    else:
        assert isinstance(state, tuple)
    before = [w.clone() for w in step.weights]
    loss = step.accum_steps(xx, ys)
    assert torch.isfinite(loss) and step._n == 3
    assert any(not torch.equal(a, b) for a, b in zip(before, step.weights))


def test_multi_precision_states_save_and_load():
    """(momentum, float32 master) tuples of a bfloat16 net through
    `Trainer.save_states` / `load_states`: float32 in the file, the
    loaded tuple updating as the saved one would."""
    import os
    import tempfile

    def trainer():
        net = _tiny("mps_")
        net.cast("bfloat16")
        return net, tmx.gluon.Trainer(
            net.collect_params(), "sgd",
            dict(learning_rate=0.1, momentum=0.9, multi_precision=True))

    def step(net, tr):
        x = tmx.nd.array(np.ones((3, 4), np.float32), ctx=CPU)
        with tmx.autograd.record():
            loss = net(x.astype("bfloat16")).sum()
        loss.backward()
        tr.step(3)

    net, tr = trainer()
    step(net, tr)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mp.states")
        tr.save_states(path)
        with open(path, "rb") as f:
            saved = pickle.load(f)
        assert all(isinstance(v, tuple) and v[1].dtype == np.float32
                   for v in saved.values())
        net2, tr2 = trainer()
        with torch.no_grad():
            for p, q in zip(net.collect_params().values(),
                            net2.collect_params().values()):
                q.tensor().copy_(p.tensor())
        tr2.load_states(path)
    tr2._optimizer._index_update_count = dict(
        tr._optimizer._index_update_count)
    step(net, tr)
    step(net2, tr2)
    for p, q in zip(net.collect_params().values(),
                    net2.collect_params().values()):
        assert torch.equal(p.tensor(), q.tensor())
