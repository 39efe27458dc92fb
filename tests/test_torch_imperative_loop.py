"""Gluon's imperative loop on the port against the JAX package's: a
thin ResNet v1 imperative step (`autograd.record` -> `net(x)` ->
`SoftmaxCrossEntropyLoss` -> `backward` -> `Trainer.step`) with the
fused epilogue off and on, from the JAX package's state (chained
thin-net steps drift in float32: ROADMAP).

The JAX reference is its train step, one jitted program as a
hybridized call is, where the JAX package applies the BN -> ReLU
(-> add) rewrite with the knob on (the port rewrites at its call sites
in every mode); with the knob off its jitted and eager calls run the
same ops. The mean loss is held at rtol 1e-5, atol 1e-6 and the weights
after the step at rtol 2e-4, atol 1e-5, as the ResNet train steps are
(`tests/test_torch_resnet.py`).
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _values(net):
    return {n[len(net.prefix):]: p.data().asnumpy()
            for n, p in net.collect_params().items()}


RES_ARGS = (1, (1, 1, 1, 1), (16, 32, 64, 128, 256))
RES_KW = dict(bottleneck=True, classes=10, layout="NHWC")
RES_BATCH = 4
RES_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def _res_data():
    rng = np.random.RandomState(0)
    x = rng.rand(RES_BATCH, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, RES_BATCH).astype(np.float32)
    return x, y


def _jax_step(knob):
    """The JAX package's ResNet step on the same batch: the state before
    it (seeded weights and running stats), the mean loss and the state
    after it, from its train step (one jitted program; the imperative
    loop's hybridized step computes the same, SGD on the batch-mean
    gradient), and the epilogue rewrites of one trace."""
    import os

    import jax
    from incubator_mxnet_tpu.fused import GluonTrainStep
    from incubator_mxnet_tpu.gluon.model_zoo.vision.resnet import ResNet
    from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray
    from incubator_mxnet_tpu.ops import epilogue as jepi

    x, y = _res_data()
    old = os.environ.get("MXTPU_FUSED_EPILOGUE")
    os.environ["MXTPU_FUSED_EPILOGUE"] = knob
    try:
        net = ResNet(*RES_ARGS, **RES_KW)
        net.initialize(jmx.init.Xavier())
        with abstract_init_mode():
            jax.eval_shape(lambda d: net(NDArray._from_data(d))._data,
                           jax.ShapeDtypeStruct(x.shape, np.float32))
        params = net.collect_params()
        before = _weights({n[len(net.prefix):]: p.shape
                           for n, p in params.items()})
        for n, p in params.items():
            p.set_data(jmx.nd.array(before[n[len(net.prefix):]]))
        loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
        step = GluonTrainStep(net, lambda n, a, b: loss_fn(n(a), b),
                              jmx.optimizer.SGD(rescale_grad=1.0 / RES_BATCH,
                                                **RES_SGD))
        jepi.rewrites_applied = 0
        loss = float(step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
        step.sync_params()
    finally:
        if old is None:
            os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
        else:
            os.environ["MXTPU_FUSED_EPILOGUE"] = old
    return before, loss, _values(net), jepi.rewrites_applied


def _weights(shapes, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("weight"):
            fans = (shape[0] + shape[1]) * np.prod(shape[2:]) / 2.0
            v = rng.uniform(-1, 1, shape) * np.sqrt(3.0 / fans)
        elif name.endswith(("gamma", "running_var")):
            v = 1.0 + 0.1 * np.abs(rng.randn(*shape))
        else:  # bias, beta, running_mean
            v = 0.1 * rng.randn(*shape)
        out[name] = v.astype(np.float32)
    return out


@pytest.mark.parametrize("knob", ["0", "1"], ids=["unfused", "fused"])
def test_resnet_imperative_step_matches_jax(knob, monkeypatch):
    """An imperative step of a thin ResNet v1 (NHWC, one bottleneck unit
    per stage) from the JAX package's state: the mean loss and every
    weight, momentum-free first step, and the running stats after it;
    with the knob on the rewrite runs at its 13 BN -> ReLU (-> add)
    sites, once per forward."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        ResNet)
    from incubator_mxnet_tpu_torch.ops import epilogue as tepi

    before, want_loss, after, jax_rewrites = _jax_step(knob)
    monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", knob)
    x, y = _res_data()
    net = ResNet(*RES_ARGS, **RES_KW)
    net.initialize(ctx=CPU)
    load_numpy_params(net, before)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(RES_SGD))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tepi.rewrites_applied = 0
    with tmx.autograd.record():
        loss = loss_fn(net(tmx.nd.array(x, ctx=CPU)),
                       tmx.nd.array(y, ctx=CPU)).mean()
    loss.backward()
    trainer.step(RES_BATCH)  # rescale_grad 1/batch on the mean's gradient
    if knob == "1":
        assert tepi.rewrites_applied == 13 and jax_rewrites >= 13
    else:
        assert tepi.rewrites_applied == 0 and jax_rewrites == 0
    np.testing.assert_allclose(float(loss.mean().asscalar()), want_loss,
                               rtol=RTOL, atol=ATOL)
    got = _values(net)
    assert set(got) == set(after)
    for k, v in after.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-4, atol=1e-5,
                                   err_msg=k)
