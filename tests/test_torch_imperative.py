"""Gluon's imperative surface on the port against the JAX package: every
new layer and loss (forward and gradient), `gluon.Trainer` steps and
state files, `gluon.data` orders and parameter files (the thin ResNet
v1 imperative step is `tests/test_torch_imperative_loop.py`,
`examples/gluon_mnist.py`'s loop `tests/test_torch_autograd.py`).

Weights are carried from the JAX package's nets
(`gluon.utils.load_numpy_params`); values are held at rtol 1e-5, atol
1e-6 and gradients at rtol 1e-4, atol 1e-5 (`tests/test_gluon.py:72,
173,273`); weights after a step at rtol 2e-4, atol 1e-5, as the ResNet
train steps are (`tests/test_torch_resnet.py`).
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6
GRTOL, GATOL = 1e-4, 1e-5


def _np(seed, *shape, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _values(net):
    return {n[len(net.prefix):]: p.data().asnumpy()
            for n, p in net.collect_params().items()}


def _arr(mx, a):
    return (mx.nd.array(a) if mx is jmx
            else tmx.nd.array(np.asarray(a), ctx=CPU))


def _heads(shapes, seed):
    hr = np.random.RandomState(seed)
    return [np.asarray(hr.randn(*s), np.float32) for s in shapes]


def _weights(shapes, seed=0):
    """Seeded values for every parameter, by relative name."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(("gamma", "running_var")):
            v = 1.0 + 0.1 * np.abs(rng.randn(*shape))
        elif name.endswith(("beta", "bias", "running_mean")):
            v = 0.1 * rng.randn(*shape)
        else:
            v = rng.uniform(-0.5, 0.5, shape)
        out[name] = v.astype(np.float32)
    return out


def _port_block(make, inputs, weights, train):
    """(outputs, input grads, param grads, params after) of the port's
    block: one recorded forward and a backward under the seeded head
    gradients."""
    net = make(tmx)
    net.initialize(ctx=CPU)
    load_numpy_params(net, {"p_" + k: v for k, v in weights.items()},
                      prefix="p_")
    xs = [tmx.nd.array(np.asarray(a), ctx=CPU) for a in inputs]
    diff = [x for x in xs if x.dtype == np.float32]
    for x in diff:
        x.attach_grad()
    with tmx.autograd.record(train_mode=train):
        out = net(*xs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    heads = _heads([o.shape for o in outs], 1)
    tmx.autograd.backward(outs, [tmx.nd.array(h, ctx=CPU) for h in heads])
    grads = {n[len(net.prefix):]: p.grad().asnumpy()
             for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in diff],
            grads, _values(net))


def _jax_block(make, inputs, train, init=None):
    """(pure fn, args, weights) of the JAX package's block: its shapes
    resolved abstractly, its parameters set to seeded values, and the
    forward traced with every parameter substituted (`_ParamSubst`) and
    the mode set, as the JAX package's hybridized call runs it. The fn
    returns (outputs, new aux values, parameter grads, input grads).
    `init` (default Xavier) fills the parameters whose shapes are known
    before the seeded values replace them."""
    import jax
    from incubator_mxnet_tpu.gluon.block import _ParamSubst
    from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray

    net = make(jmx)
    net.initialize(init or jmx.init.Xavier())
    specs = [jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype)
             for a in inputs]

    def call(*datas):
        out = net(*[NDArray._from_data(d) for d in datas])
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [o._data for o in outs]

    with abstract_init_mode():
        out_specs = jax.eval_shape(call, *specs)
    params = net.collect_params()
    names = list(params)
    weights = _weights({n[len(net.prefix):]: params[n].shape
                        for n in names})
    pvals = [weights[n[len(net.prefix):]] for n in names]
    for n, v in zip(names, pvals):
        params[n].set_data(jmx.nd.array(v))
    trained = [k for k, n in enumerate(names)
               if params[n].grad_req != "null"]
    fi = [k for k, a in enumerate(inputs)
          if np.asarray(a).dtype == np.float32]
    heads = _heads([o.shape for o in out_specs], 1)

    def forward(pv, xv):
        full_p = list(pvals)
        for k, v in zip(trained, pv):
            full_p[k] = v
        full_x = [np.asarray(a) for a in inputs]
        for k, v in zip(fi, xv):
            full_x[k] = v
        mapping = {n: NDArray._from_data(v) for n, v in zip(names, full_p)}
        prev_t = jmx.autograd.set_training(train)
        prev_r = jmx.autograd.set_recording(False)
        try:
            with _ParamSubst(mapping):
                outs = call(*full_x)
        finally:
            jmx.autograd.set_training(prev_t)
            jmx.autograd.set_recording(prev_r)
        aux = [mapping[names[k]]._data for k in range(len(names))
               if k not in trained]
        return list(outs), aux

    def g(pv, xv):
        outs, pull, aux = jax.vjp(forward, pv, xv, has_aux=True)
        gp, gx = pull(list(heads))
        return outs, aux, gp, gx

    args = ([pvals[k] for k in trained], [np.asarray(inputs[k]) for k in fi])
    rel = [names[k][len(net.prefix):] for k in trained]
    aux_rel = [names[k][len(net.prefix):] for k in range(len(names))
               if k not in trained]
    return g, args, weights, rel, aux_rel


_JAX = {}


def _jax_results():
    """Every layer and loss case's JAX result, the forwards and vjps of
    all of them compiled as one program."""
    if _JAX:
        return _JAX
    import jax

    built = {key: _jax_block(make, inputs, train)
             for key, (make, inputs, train) in _BLOCK_CASES.items()}
    out = jax.jit(lambda a: {k: built[k][0](*a[k]) for k in built})(
        {k: b[1] for k, b in built.items()})
    for k, (outs, aux, gp, gx) in out.items():
        _, _, weights, rel, aux_rel = built[k]
        _JAX[k] = ([np.asarray(o) for o in outs],
                   [np.asarray(x) for x in gx],
                   {n: np.asarray(v) for n, v in zip(rel, gp)},
                   {n: np.asarray(v) for n, v in zip(aux_rel, aux)},
                   weights)
    return _JAX


def _parity(key):
    make, inputs, train = _BLOCK_CASES[key]
    outs, gx, gp, aux, weights = _jax_results()[key]
    got = _port_block(make, inputs, weights, train)
    for g, w in zip(got[0], outs):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert len(got[1]) == len(gx)
    for g, w in zip(got[1], gx):
        np.testing.assert_allclose(g, w, rtol=GRTOL, atol=GATOL)
    assert set(got[2]) == set(gp)
    for k in gp:
        np.testing.assert_allclose(got[2][k], gp[k], rtol=GRTOL,
                                   atol=GATOL, err_msg=k)
    for k, v in aux.items():  # running stats after the call
        np.testing.assert_allclose(got[3][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)


X4 = _np(0, 2, 4, 5, 6)
X3 = _np(0, 2, 3, 6)
X5 = _np(0, 2, 3, 4, 5, 4)

LAYERS = {
    "InstanceNorm": (lambda mx: mx.gluon.nn.InstanceNorm(), [X4]),
    "LayerNorm": (lambda mx: mx.gluon.nn.LayerNorm(), [X4]),
    "GroupNorm": (lambda mx: mx.gluon.nn.GroupNorm(num_groups=2), [X4]),
    "ReflectionPad2D": (lambda mx: mx.gluon.nn.ReflectionPad2D(2), [X4]),
    "Embedding": (lambda mx: mx.gluon.nn.Embedding(7, 3),
                  [np.array([[0, 6, 2], [5, 5, 1]], np.int32)]),
    "LeakyReLU": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), [X3]),
    "ELU": (lambda mx: mx.gluon.nn.ELU(0.7), [X3]),
    "SELU": (lambda mx: mx.gluon.nn.SELU(), [X3]),
    "GELU": (lambda mx: mx.gluon.nn.GELU(), [X3]),
    "PReLU": (lambda mx: mx.gluon.nn.PReLU(in_channels=3), [X3]),
    "Swish": (lambda mx: mx.gluon.nn.Swish(beta=1.5), [X3]),
    "Conv1D": (lambda mx: mx.gluon.nn.Conv1D(4, 3, strides=2, padding=1),
               [X3]),
    "Conv3D": (lambda mx: mx.gluon.nn.Conv3D(2, (2, 3, 2), padding=1,
                                             activation="relu"), [X5]),
    "Conv1DTranspose": (lambda mx: mx.gluon.nn.Conv1DTranspose(
        2, 3, strides=2, padding=1, output_padding=1), [X3]),
    "Conv2DTranspose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        3, (3, 2), strides=(2, 1), padding=(1, 0)), [X4]),
    "Conv3DTranspose": (lambda mx: mx.gluon.nn.Conv3DTranspose(
        2, 2, strides=2, use_bias=False), [X5]),
    "MaxPool1D": (lambda mx: mx.gluon.nn.MaxPool1D(3, 2, ceil_mode=True),
                  [X3]),
    "MaxPool3D": (lambda mx: mx.gluon.nn.MaxPool3D(2), [X5]),
    "AvgPool1D": (lambda mx: mx.gluon.nn.AvgPool1D(2, padding=1,
                                                   count_include_pad=False),
                  [X3]),
    "AvgPool2D": (lambda mx: mx.gluon.nn.AvgPool2D((2, 3)), [X4]),
    "AvgPool3D": (lambda mx: mx.gluon.nn.AvgPool3D(2, ceil_mode=True),
                  [X5]),
    "GlobalMaxPool1D": (lambda mx: mx.gluon.nn.GlobalMaxPool1D(), [X3]),
    "GlobalMaxPool2D": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(), [X4]),
    "GlobalMaxPool3D": (lambda mx: mx.gluon.nn.GlobalMaxPool3D(), [X5]),
    "GlobalAvgPool1D": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(), [X3]),
    "GlobalAvgPool3D": (lambda mx: mx.gluon.nn.GlobalAvgPool3D(), [X5]),
    "Sequential": (lambda mx: _seq(mx), [_np(1, 4, 6)]),
    "HybridLambda": (lambda mx: mx.gluon.nn.HybridLambda("tanh"), [X3]),
    "Lambda": (lambda mx: mx.gluon.nn.Lambda(lambda x: x * 2 + 1), [X3]),
    "Dropout(predict)": (lambda mx: mx.gluon.nn.Dropout(0.4), [X3]),
}


def _seq(mx):
    net = mx.gluon.nn.Sequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(5, activation="tanh"),
                mx.gluon.nn.BatchNorm(), mx.gluon.nn.Dense(3))
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    _parity(f"layer:{name}")


def test_dropout_layer_follows_the_mode():
    net = tmx.gluon.nn.Dropout(0.5)
    x = tmx.nd.ones((50, 40), ctx=CPU)
    with tmx.autograd.record():
        y = net(x)
    frac = float((y.asnumpy() == 0).mean())
    assert 0.35 < frac < 0.65
    with tmx.autograd.record(train_mode=False):
        assert (net(x).asnumpy() == 1).all()
    assert (net(x).asnumpy() == 1).all()
    # a tensor caller follows the block's own flag, as before
    net.train()
    assert (net(torch.ones(50, 40)) == 0).any()


LABEL5 = np.array([0, 4, 2, 1], np.float32)
SIGNED = np.sign(_np(3, 4, 5)).astype(np.float32)
LOSSES = {
    "L2Loss": (lambda mx: mx.gluon.loss.L2Loss(weight=0.5),
               [_np(1, 4, 5), _np(2, 4, 5)]),
    "L1Loss": (lambda mx: mx.gluon.loss.L1Loss(),
               [_np(1, 4, 5), _np(2, 4, 5)]),
    "SigmoidBCE": (lambda mx: mx.gluon.loss.SigmoidBinaryCrossEntropyLoss(),
                   [_np(1, 4, 5), _np(2, 4, 5, lo=0, hi=1)]),
    "SigmoidBCE(from_sigmoid)": (
        lambda mx: mx.gluon.loss.SigmoidBCELoss(from_sigmoid=True),
        [_np(1, 4, 5, lo=0.1, hi=0.9), _np(2, 4, 5, lo=0, hi=1)]),
    "SoftmaxCE(dense)": (
        lambda mx: mx.gluon.loss.SoftmaxCELoss(sparse_label=False),
        [_np(1, 4, 5), _np(2, 4, 5, lo=0, hi=1)]),
    "SoftmaxCE(sparse, weighted)": (
        lambda mx: mx.gluon.loss.SoftmaxCrossEntropyLoss(weight=2.0),
        [_np(1, 4, 5), LABEL5, _np(4, 4, 1, lo=0, hi=1)]),
    "KLDivLoss": (lambda mx: mx.gluon.loss.KLDivLoss(from_logits=False),
                  [_np(1, 4, 5), _np(2, 4, 5, lo=0.1, hi=1)]),
    "HuberLoss": (lambda mx: mx.gluon.loss.HuberLoss(rho=0.5),
                  [_np(1, 4, 5), _np(2, 4, 5)]),
    "HingeLoss": (lambda mx: mx.gluon.loss.HingeLoss(),
                  [_np(1, 4, 5), SIGNED]),
    "SquaredHingeLoss": (lambda mx: mx.gluon.loss.SquaredHingeLoss(margin=2),
                         [_np(1, 4, 5), SIGNED]),
    "LogisticLoss": (lambda mx: mx.gluon.loss.LogisticLoss(),
                     [_np(1, 4, 5), SIGNED]),
    "LogisticLoss(binary)": (
        lambda mx: mx.gluon.loss.LogisticLoss(label_format="binary"),
        [_np(1, 4, 5), (SIGNED > 0).astype(np.float32)]),
    "TripletLoss": (lambda mx: mx.gluon.loss.TripletLoss(margin=0.5),
                    [_np(1, 4, 5), _np(2, 4, 5), _np(3, 4, 5)]),
    "CosineEmbeddingLoss": (
        lambda mx: mx.gluon.loss.CosineEmbeddingLoss(margin=0.1),
        [_np(1, 4, 5), _np(2, 4, 5), np.array([1, -1, 1, -1], np.float32)]),
    "PoissonNLLLoss": (
        lambda mx: mx.gluon.loss.PoissonNLLLoss(compute_full=True),
        [_np(1, 4, 5), _np(2, 4, 5, lo=0, hi=4).round()]),
}


def _pos_weight_bce(mx):
    """SigmoidBCELoss with a pos_weight (and no sample_weight)."""
    class PosWeightBCE(mx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.loss = mx.gluon.loss.SigmoidBCELoss()

        def hybrid_forward(self, F, pred, label, pos_weight):
            return self.loss(pred, label, None, pos_weight)

    return PosWeightBCE()


LOSSES["SigmoidBCE(pos_weight)"] = (
    _pos_weight_bce, [_np(1, 4, 5), _np(2, 4, 5, lo=0, hi=1),
                      _np(3, 1, 5, lo=0.5, hi=2)])

_BLOCK_CASES = {
    **{f"layer:{n}": (make, inputs, n != "Dropout(predict)")
       for n, (make, inputs) in LAYERS.items()},
    **{f"loss:{n}": (make, inputs, True)
       for n, (make, inputs) in LOSSES.items()},
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    _parity(f"loss:{name}")


# -- Trainer -----------------------------------------------------------------

def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(6, activation="relu", in_units=5),
                mx.gluon.nn.Dense(3, in_units=6))
    return net


SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
TX, TY = _np(5, 8, 5), np.array([0, 2, 1, 1, 0, 2, 2, 0], np.float32)


def _configure(trainer, net):
    names = list(net.collect_params().keys())
    trainer.optimizer.set_wd_mult({})
    trainer.optimizer.set_lr_mult({names[1]: 0.5})


def _jax_trainer_steps(steps):
    """The JAX package's Trainer: for each step the weights and momenta
    before it, the loss and the weights after it."""
    jmx.random.seed(0)
    net = _mlp(jmx)
    net.initialize(jmx.init.Xavier())
    trainer = jmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    _configure(trainer, net)
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for _ in range(steps):
        before = _values(net)
        moms = {i: s.asnumpy() for i, s in trainer._updater.states.items()
                if s is not None}
        with jmx.autograd.record():
            loss = loss_fn(net(jmx.nd.array(TX)), jmx.nd.array(TY))
        loss.backward()
        trainer.step(TX.shape[0])
        out.append((before, moms, float(loss.mean().asscalar()),
                    _values(net)))
    return net, trainer, out


def test_trainer_steps_match_jax():
    """SGD with momentum, weight decay and lr / wd multipliers
    (`set_lr_mult`, `set_wd_mult`: biases get no weight decay), three
    steps, each replayed from the JAX state before it."""
    jnet, _, records = _jax_trainer_steps(3)
    net = _mlp(tmx)
    net.initialize(ctx=CPU)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    _configure(trainer, net)
    assert trainer.learning_rate == 0.1
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    prefix = "x_"
    for i, (before, moms, want_loss, after) in enumerate(records):
        load_numpy_params(net, {prefix + k: v for k, v in before.items()},
                          prefix=prefix)
        for k, m in moms.items():
            trainer._updater.states[k]._data.copy_(torch.from_numpy(m))
        with tmx.autograd.record():
            loss = loss_fn(net(tmx.nd.array(TX, ctx=CPU)),
                           tmx.nd.array(TY, ctx=CPU))
        loss.backward()
        trainer.step(TX.shape[0])
        np.testing.assert_allclose(float(loss.mean().asscalar()), want_loss,
                                   rtol=RTOL, atol=ATOL)
        got = _values(net)
        for k, v in after.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} after step {i + 1}")
    assert trainer.optimizer.num_update == 3
    trainer.set_learning_rate(0.01)
    assert trainer.learning_rate == 0.01


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_trainer_state_files_interchange(direction, tmp_path):
    """`save_states` files ({index: float32 momentum}) load in the other
    package and give the same states."""
    _, jtrainer, _ = _jax_trainer_steps(2)
    net = _mlp(tmx)
    net.initialize(ctx=CPU)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    path = str(tmp_path / "states")
    if direction == "jax_to_port":
        jtrainer.save_states(path)
        trainer.load_states(path)
        want = jtrainer._updater.states
        got = trainer._updater.states
    else:
        for i, s in jtrainer._updater.states.items():
            trainer._updater.states[i] = tmx.nd.array(s.asnumpy(), ctx=CPU)
        trainer.save_states(path)
        jtrainer._updater.states = {}
        jtrainer.load_states(path)
        want = trainer._updater.states
        got = jtrainer._updater.states
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())


@pytest.mark.parametrize("policy", ["skip", "rollback", "backoff"])
def test_guardrail_policies(policy, monkeypatch):
    monkeypatch.setenv("MXTPU_GUARDRAIL_POLICY", policy)
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd")
    before = net.weight.data().asnumpy()
    x = tmx.nd.array(np.full((2, 3), np.inf, np.float32), ctx=CPU)
    with tmx.autograd.record():
        y = net(x).sum()
    y.backward()
    if policy == "skip":
        trainer.step(2)
        np.testing.assert_array_equal(net.weight.data().asnumpy(), before)
    elif policy == "rollback":
        with pytest.raises(tmx.gluon.trainer.GuardrailRollback):
            trainer.step(2)
    else:
        # the step is skipped and a unit loss scaler pinned at 1.0 is
        # attached (contrib.amp's), as in the JAX package
        trainer.step(2)
        np.testing.assert_array_equal(net.weight.data().asnumpy(), before)
        assert trainer._amp_scaler.loss_scale == 1.0


def test_trainer_step_span_and_histogram():
    from incubator_mxnet_tpu_torch import telemetry

    was = telemetry.enabled()
    telemetry.enable()
    try:
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize(ctx=CPU)
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd")
        with tmx.autograd.record():
            y = net(tmx.nd.ones((2, 3), ctx=CPU)).sum()
        y.backward()
        trainer.step(2)
        text = telemetry.prometheus_text()
        assert "mxtpu_trainer_step_seconds_count" in text
    finally:
        if not was:
            telemetry.disable()


def test_checkpoint_bundle_and_auto_resume(tmp_path):
    """save_checkpoint / save_bundle write crash-consistent files; a
    resume restores the parameters, the states, the loader's cursor and
    the global random state."""
    net = _mlp(tmx)
    net.initialize(ctx=CPU)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loader = tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(TX, TY),
                                       batch_size=2, shuffle=True)
    it = iter(loader)
    for _ in range(2):
        x, y = next(it)
        with tmx.autograd.record():
            loss = tmx.gluon.loss.SoftmaxCELoss()(net(x), y)
        loss.backward()
        trainer.step(2)
    prefix = str(tmp_path / "run")
    trainer.save_checkpoint(prefix, 0, net=net)
    tmx.random.seed(11)
    tmx.random.next_key()
    rng = tmx.random.get_state()
    trainer.save_bundle(prefix, 1, net=net, loader=loader)
    want_w = _values(net)
    want_s = {k: v.asnumpy() for k, v in trainer._updater.states.items()}
    rest = [b[1].asnumpy() for b in it]

    net2 = _mlp(tmx)
    net2.initialize(ctx=CPU)
    trainer2 = tmx.gluon.Trainer(net2.collect_params(), "sgd", dict(SGD))
    loader2 = tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(TX, TY),
                                        batch_size=2, shuffle=True)
    tmx.random.seed(0)
    assert trainer2.auto_resume(prefix, net=net2, loader=loader2) == 1
    assert tmx.random.get_state() == rng
    for k, v in want_w.items():
        np.testing.assert_array_equal(_values(net2)[k], v)
    for k, v in want_s.items():
        np.testing.assert_array_equal(
            trainer2._updater.states[k].asnumpy(), v)
    got_rest = [b[1].asnumpy() for b in loader2]
    assert len(got_rest) == len(rest)
    for g, w in zip(got_rest, rest):
        np.testing.assert_array_equal(g, w)
    # without the bundle: the epoch checkpoint, resumed at epoch 1
    tmx.resilience.clear_bundle(prefix)
    assert trainer2.auto_resume(prefix, net=net2) == 1


# -- parameter files ---------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_parameter_files_interchange(direction, tmp_path):
    jmx.random.seed(0)
    jnet = _mlp(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(TX))
    net = _mlp(tmx)
    net.initialize(ctx=CPU)
    path = str(tmp_path / "net.params")
    if direction == "jax_to_port":
        jnet.save_parameters(path)
        net.load_parameters(path)
        src, dst = jnet, net
    else:
        load_numpy_params(net, _values(jnet), prefix="")
        net.save_parameters(path)
        jnet2 = _mlp(jmx)
        jnet2.initialize(jmx.init.Zero())
        jnet2.load_parameters(path)
        src, dst = net, jnet2
    assert sorted(_values(src)) == sorted(_values(dst))
    for k, v in _values(src).items():
        np.testing.assert_array_equal(_values(dst)[k], v)
    # the full-name ParameterDict files too
    pd_path = str(tmp_path / "pd.params")
    net.collect_params().save(pd_path, strip_prefix=net.prefix)
    net3 = _mlp(tmx)
    net3.initialize(ctx=CPU)
    net3.collect_params().load(pd_path, restore_prefix=net3.prefix)
    for k, v in _values(net).items():
        np.testing.assert_array_equal(_values(net3)[k], v)


# -- gluon.data --------------------------------------------------------------

def _orders(mx, seed, **kw):
    np.random.seed(seed)
    data = np.arange(23, dtype=np.float32)
    ds = mx.gluon.data.ArrayDataset(data, data * 2)
    loader = mx.gluon.data.DataLoader(ds, batch_size=4, shuffle=True, **kw)
    return loader, [[b[0].asnumpy().tolist() for b in loader]
                    for _ in range(2)]


@pytest.mark.parametrize("kw", [{}, {"last_batch": "discard"},
                                {"last_batch": "rollover"},
                                {"num_workers": 2}],
                         ids=["keep", "discard", "rollover", "threads"])
def test_dataloader_orders_equal_jax(kw):
    _, got = _orders(tmx, 3, **kw)
    _, want = _orders(jmx, 3, **kw)
    assert got == want
    assert got[0] != got[1]


def test_dataloader_resume_mid_epoch_equal_jax():
    out = []
    for mx in (tmx, jmx):
        loader, _ = _orders(mx, 5)
        it = iter(loader)
        [next(it) for _ in range(3)]
        state = loader.state_dict()
        rest = [b[0].asnumpy().tolist() for b in it]
        np.random.seed(99)
        fresh = mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(np.arange(23, dtype=np.float32)),
            batch_size=4, shuffle=True)
        fresh.load_state_dict(state)
        again = [b.asnumpy().tolist() for b in fresh]
        assert again == rest
        out.append(rest)
    assert out[0] == out[1]


def test_datasets_and_samplers():
    ds = tmx.gluon.data.SimpleDataset(list(range(10)))
    assert len(ds.filter(lambda v: v % 2)) == 5
    assert list(ds.take(3)) == [0, 1, 2]
    assert list(ds.transform(lambda v: v * 10))[:2] == [0, 10]
    pairs = tmx.gluon.data.ArrayDataset(np.arange(4), np.arange(4) * 3)
    assert pairs.transform_first(lambda v: v + 1)[2] == (3, 6)
    bs = tmx.gluon.data.BatchSampler(tmx.gluon.data.SequentialSampler(5), 2)
    assert list(bs) == [[0, 1], [2, 3], [4]] and len(bs) == 3
    x, y = next(iter(tmx.gluon.data.DataLoader(pairs, batch_size=3)))
    assert x.context == tmx.cpu() and x.shape == (3,)


# -- utils -------------------------------------------------------------------

def test_split_and_load_and_clip_global_norm():
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    parts = tmx.gluon.utils.split_and_load(data, [CPU, CPU])
    assert [p.shape for p in parts] == [(2, 3), (2, 3)]
    np.testing.assert_array_equal(parts[1].asnumpy(), data[2:])
    with pytest.raises(ValueError):
        tmx.gluon.utils.split_data(tmx.nd.array(data, ctx=CPU), 3)
    arrays = [_np(1, 3, 4), _np(2, 5)]
    got_in = [tmx.nd.array(a, ctx=CPU) for a in arrays]
    want_in = [jmx.nd.array(a) for a in arrays]
    got = tmx.gluon.utils.clip_global_norm(got_in, 1.0)
    want = jmx.gluon.utils.clip_global_norm(want_in, 1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for g, w in zip(got_in, want_in):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
