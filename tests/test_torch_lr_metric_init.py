"""The port's learning-rate schedules, metrics, initializers and callbacks
against the JAX package's, on the CPU.

Schedules: every rate over updates 0-300, exactly. Metrics: every entry
of `metric.create`'s table on the same seeded labels and predictions,
at rtol 1e-6 (port NDArrays and torch tensors alike). Initializers: the
deterministic ones exactly (Constant, Bilinear, LSTMBias, FusedRNN's
layout, Mixed, Load); Normal, Orthogonal and MSRAPrelu by their moments
and orthogonality, since the generators differ. Callbacks: the same log
lines for the same metric.
"""
import logging

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.model import BatchEndParam

CPU = tmx.cpu()

SCHEDULES = {
    "factor": ("FactorScheduler", dict(step=25, factor=0.7,
                                       stop_factor_lr=1e-3, base_lr=0.5,
                                       warmup_steps=10,
                                       warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(step=[40, 90, 200],
                                                 factor=0.1, base_lr=0.05)),
    "poly": ("PolyScheduler", dict(max_update=250, base_lr=0.1, pwr=2,
                                   final_lr=1e-4, warmup_steps=20,
                                   warmup_mode="quadratic")),
    "cosine": ("CosineScheduler", dict(max_update=280, base_lr=0.2,
                                       final_lr=0.002, warmup_steps=15)),
    "warmup_only": ("FactorScheduler", dict(step=1000, base_lr=0.3,
                                            warmup_steps=300,
                                            warmup_begin_lr=0.0)),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_matches_jax_exactly(case):
    cls, kw = SCHEDULES[case]
    t = getattr(tmx.lr_scheduler, cls)(**kw)
    j = getattr(jmx.lr_scheduler, cls)(**kw)
    assert [t(n) for n in range(301)] == [j(n) for n in range(301)]


def test_scheduler_drives_the_optimizer_rate():
    sched = tmx.lr_scheduler.MultiFactorScheduler(step=[2, 4], factor=0.1)
    o = tmx.optimizer.SGD(learning_rate=0.05, lr_scheduler=sched)
    w = tmx.nd.array(np.zeros(3, np.float32), ctx=CPU)
    rates = []
    for _ in range(6):
        o.update(0, w, tmx.nd.ones((3,), ctx=CPU), None)
        rates.append(o._get_lr(0))
    assert rates == [0.05, 0.05, 0.05 * 0.1, 0.05 * 0.1,
                     0.05 * 0.1 ** 2, 0.05 * 0.1 ** 2]


# -- metrics -------------------------------------------------------------------

def _cls_batch(rng, n=12, k=5):
    logits = rng.randn(n, k).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return rng.randint(0, k, n).astype(np.float32), probs.astype(np.float32)


def _bin_batch(rng, n=16):
    p = rng.rand(n, 2).astype(np.float32)
    return rng.randint(0, 2, n).astype(np.float32), p


def _reg_batch(rng, n=10):
    return rng.randn(n, 1).astype(np.float32), rng.randn(n, 1).astype(
        np.float32)


def _feval(label, pred):
    return float(np.abs(label.reshape(-1) - pred.argmax(-1)).mean())


METRICS = {
    "acc": ((), _cls_batch), "top_k_accuracy": ((3,), _cls_batch),
    "f1": ((), _bin_batch), "mcc": ((), _bin_batch),
    "perplexity": ((), _cls_batch), "mae": ((), _reg_batch),
    "mse": ((), _reg_batch), "rmse": ((), _reg_batch),
    "ce": ((), _cls_batch), "nll_loss": ((), _cls_batch),
    "pearsoncorrelation": ((), _reg_batch), "loss": ((), _reg_batch),
    "torch": ((), _reg_batch), "caffe": ((), _reg_batch),
    "composite": (([("acc", "ce")]), _cls_batch),
    "custom": ((_feval,), _cls_batch),
}


def _kinds(mx, arrays, kind):
    if mx is jmx:
        return [jmx.nd.array(a) for a in arrays]
    if kind == "torch":
        return [torch.from_numpy(a) for a in arrays]
    return [tmx.nd.array(a, ctx=CPU) for a in arrays]


@pytest.mark.parametrize("kind", ["ndarray", "torch"])
@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_jax(name, kind):
    args, batch = METRICS[name]
    rng = np.random.RandomState(len(name))
    batches = [batch(rng) for _ in range(2)]
    values = []
    for mx in (tmx, jmx):
        if name == "composite":
            m = mx.metric.create(list(args[0]))
        elif name == "custom":
            m = mx.metric.create(args[0])
        else:
            m = mx.metric.create(name, *args)
        for label, pred in batches:
            m.update(_kinds(mx, [label], kind), _kinds(mx, [pred], kind))
        values.append(m.get())
    (tn, tv), (jn, jv) = values
    assert tn == jn
    np.testing.assert_allclose(np.asarray(tv, np.float64),
                               np.asarray(jv, np.float64), rtol=1e-6)


def test_metric_np_wrapper_and_names():
    tm = tmx.metric.np(_feval, name="gap")
    jm = jmx.metric.np(_feval, name="gap")
    label, pred = _cls_batch(np.random.RandomState(0))
    tm.update([tmx.nd.array(label, ctx=CPU)], [tmx.nd.array(pred, ctx=CPU)])
    jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    assert tm.get() == pytest.approx(jm.get())
    for alias in ("acc", "ce", "top_k_acc", "cross-entropy",
                  "pearson_correlation", "composite", "Accuracy"):
        assert type(tmx.metric.create(alias)).__name__ == \
            type(jmx.metric.create(alias)).__name__


# -- initializers --------------------------------------------------------------

def _jax_init(init, name, shape):
    arr = jmx.nd.zeros(shape)
    init(jmx.init.InitDesc(name), arr)
    return arr.asnumpy()


def _port_init(init, name, shape):
    arr = torch.zeros(shape)
    init(tmx.init.InitDesc(name), arr)
    return arr.numpy()


DETERMINISTIC = {
    "constant": (lambda m: m.init.Constant(0.25), "c_weight", (3, 4)),
    "bilinear": (lambda m: m.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
    "lstmbias": (lambda m: m.init.LSTMBias(forget_bias=1.5), "l_i2h_bias",
                 (16,)),
    "fusedrnn": (lambda m: m.init.FusedRNN(m.init.Constant(0.1), 3, 2,
                                           "lstm", True, 2.0),
                 "rnn_parameters", (4 * 3 * (5 + 3 + 2) * 2
                                    + 4 * 3 * (6 + 3 + 2) * 2,)),
    "mixed": (lambda m: m.init.Mixed([".*bias", ".*"],
                                     [m.init.One(), m.init.Constant(2.0)]),
              "m_bias", (5,)),
    "create": (lambda m: m.initializer.create("constant", value=0.5),
               "k_weight", (2, 3)),
    "dumps": (lambda m: m.initializer.create(m.init.Constant(0.75).dumps()),
              "d_weight", (2, 2)),
}


@pytest.mark.parametrize("case", list(DETERMINISTIC))
def test_deterministic_initializer_matches_jax(case):
    make, name, shape = DETERMINISTIC[case]
    np.testing.assert_array_equal(_port_init(make(tmx), name, shape),
                                  _jax_init(make(jmx), name, shape))


def test_load_initializer_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 2).astype(np.float32)
    tl = tmx.init.Load({"arg:p_weight": tmx.nd.array(w, ctx=CPU)},
                       default_init=tmx.init.One())
    jl = jmx.init.Load({"arg:p_weight": jmx.nd.array(w)},
                       default_init=jmx.init.One())
    for name in ("p_weight", "q_bias"):
        np.testing.assert_array_equal(_port_init(tl, name, (3, 2)),
                                      _jax_init(jl, name, (3, 2)))


def test_random_initializers_by_moments_and_orthogonality():
    tmx.random.seed(0)
    n = _port_init(tmx.init.Normal(0.02), "n_weight", (256, 256))
    assert abs(n.mean()) < 5 * 0.02 / 256 and abs(n.std() - 0.02) < 1e-3
    for rand_type in ("uniform", "normal"):
        q = _port_init(tmx.init.Orthogonal(1.414, rand_type), "o_weight",
                       (16, 32))
        np.testing.assert_allclose(q @ q.T, 1.414 ** 2 * np.eye(16),
                                   atol=1e-4)
        jq = _jax_init(jmx.init.Orthogonal(1.414, rand_type), "o_weight",
                       (16, 32))
        np.testing.assert_allclose(jq @ jq.T, 1.414 ** 2 * np.eye(16),
                                   atol=1e-4)
    m = _port_init(tmx.init.MSRAPrelu(slope=0.25), "c_weight",
                   (128, 64, 3, 3))
    fan = (64 * 9 + 128 * 9) / 2.0
    std = np.sqrt(2.0 / (1 + 0.25 ** 2) / fan)
    assert abs(m.std() - std) < 0.02 * std and abs(m.mean()) < 1e-3
    assert tmx.init.MSRAPrelu(slope=0.25).dumps() == \
        jmx.init.MSRAPrelu(slope=0.25).dumps()


# -- callbacks -----------------------------------------------------------------

def _messages(mx, caplog, make_param):
    m = mx.metric.create("acc")
    label, pred = _cls_batch(np.random.RandomState(2))
    kw = {"ctx": CPU} if mx is tmx else {}
    m.update([mx.nd.array(label, **kw)], [mx.nd.array(pred, **kw)])
    caplog.clear()
    with caplog.at_level(logging.INFO):
        mx.callback.log_train_metric(2)(make_param(1, 4, m))
        mx.callback.ProgressBar(8, length=10)(make_param(0, 3, m))
        mx.callback.LogValidationMetricsCallback()(make_param(2, 0, m))
        speedo = mx.callback.Speedometer(16, frequent=2, auto_reset=False)
        for nb in range(5):
            speedo(make_param(0, nb, m))
    return [r.getMessage().split("Speed:")[0] for r in caplog.records]


def test_callbacks_log_as_jax(caplog):
    got = _messages(tmx, caplog, lambda e, n, m: BatchEndParam(e, n, m, {}))
    want = _messages(jmx, caplog,
                     lambda e, n, m: jmx.model.BatchEndParam(e, n, m, {}))
    assert got == want and len(got) == 5
    with pytest.raises(NotImplementedError, match="Queue A 6"):
        tmx.callback.do_checkpoint("x")
    with pytest.raises(NotImplementedError, match="Queue A 6"):
        tmx.callback.module_checkpoint(None, "x")
