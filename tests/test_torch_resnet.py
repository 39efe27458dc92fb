"""ResNet training through the port's gluon front end against the JAX
package (CPU): a thin v1 bottleneck net,
`ResNet(1, (1, 1, 1, 1), (16, 32, 64, 128, 256), bottleneck=True,
classes=10, layout="NHWC")` at 32 x 32, batch 4, with the same weights
on both sides (drawn with numpy from a seed: Xavier-scaled conv and dense
weights, BN affine and running stats near their defaults; set on the JAX
net, carried to the port by `load_numpy_params`), the bench's SGD (lr 0.05,
momentum 0.9, wd 1e-4, rescale_grad 1/batch) and `GluonTrainStep` on both
sides, with `MXTPU_FUSED_EPILOGUE` off and on (the JAX side runs its
Pallas epilogue in interpret mode).

Each of the 3 steps starts the port from the JAX step's state (weights,
momentum, running stats) and holds the loss at rtol 1e-5 / atol 1e-6 and
every parameter and running stat after it at rtol 2e-4 / atol 1e-5.
Chained runs are not held to these tolerances: at this size stage 4's
BatchNorm normalises over 4 values (1 x 1 pixels, batch 4), which
amplifies float32 rounding; the port and JAX, 2e-7 to 4e-7 apart in the
loss after step 1, part by 1.1e-3 to 3.5e-3 at step 3, and JAX's own
knob-off and knob-on runs by 1.0e-2 (`tests/torch_float32_drift.py`).
"""
import numpy as np

import jax
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import gluon, nd
from incubator_mxnet_tpu.fused import GluonTrainStep
from incubator_mxnet_tpu.gluon.model_zoo.vision.resnet import ResNet
from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu.ops import epilogue as jepi
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.fused import GluonTrainStep as TStep
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    ResNet as TResNet)
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params
from incubator_mxnet_tpu_torch.ops import epilogue as tepi

ARGS = (1, (1, 1, 1, 1), (16, 32, 64, 128, 256))
KW = dict(bottleneck=True, classes=10, layout="NHWC")
BATCH = 4
SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
           rescale_grad=1.0 / BATCH)
STEPS = 3
REWRITES_PER_FORWARD = 13  # the stem + 3 per unit x 4 units


def _data():
    rng = np.random.RandomState(0)
    x = rng.rand(BATCH, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, BATCH).astype(np.float32)
    return x, y


def _jax_net(x):
    """The JAX net, shapes resolved abstractly, every parameter set from
    `_weights`."""
    net = ResNet(*ARGS, **KW)
    net.initialize(mx.init.Xavier())
    with abstract_init_mode():
        jax.eval_shape(lambda d: net(NDArray._from_data(d))._data,
                       jax.ShapeDtypeStruct(x.shape, np.float32))
    params = net.collect_params()
    for name, value in _weights({n: p.shape for n, p in
                                 params.items()}).items():
        params[name].set_data(nd.array(value))
    return net


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


def _values(net):
    return {n[len(net.prefix):]: np.asarray(p.data()._data)
            for n, p in net.collect_params().items()}


def _port_net(arrays):
    net = TResNet(*ARGS, **KW)
    net.initialize(tmx.init.Xavier(), device="cpu")
    load_numpy_params(net, arrays)
    return net


def test_predict_mode_logits_match_jax(monkeypatch):
    monkeypatch.delenv("MXTPU_FUSED_EPILOGUE", raising=False)
    x, _ = _data()
    jnet = _jax_net(x)
    net = _port_net(_values(jnet))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    # one jit of the whole forward (the eager ops compile one by one)
    want = np.asarray(jax.jit(lambda d: jnet(NDArray._from_data(d))._data)(
        x))
    assert got.shape == (BATCH, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX GluonTrainStep runs, knob off and on: for each step the state
    before it (weights with running stats, momentum by name), the loss,
    and the weights after it; and the rewrites of one build."""
    import os

    x, y = _data()
    runs = {}
    old = os.environ.get("MXTPU_FUSED_EPILOGUE")
    try:
        for knob in ("0", "1"):
            os.environ["MXTPU_FUSED_EPILOGUE"] = knob
            net = _jax_net(x)
            loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
            step = GluonTrainStep(net, lambda n, a, b: loss_fn(n(a), b),
                                  mx.optimizer.SGD(**SGD))
            jepi.rewrites_applied = 0
            records = []
            for i in range(STEPS):
                before = _values(net)
                moms = ({} if i == 0 else
                        {n[len(net.prefix):]: np.asarray(s)
                         for n, s in zip(step.names, step._states)
                         if s is not None})
                loss = float(step(nd.array(x), nd.array(y)).asnumpy())
                if i == 0:
                    rewrites = jepi.rewrites_applied
                step.sync_params()
                records.append((before, moms, loss, _values(net)))
            runs[knob] = (records, rewrites)
    finally:
        if old is None:
            os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
        else:
            os.environ["MXTPU_FUSED_EPILOGUE"] = old
    return runs


@pytest.mark.parametrize("knob", ["0", "1"], ids=["unfused", "fused"])
def test_train_steps_match_jax(knob, jax_steps, monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", knob)
    records, jax_rewrites = jax_steps[knob]
    x, y = (torch.from_numpy(a) for a in _data())
    net = _port_net(records[0][0])
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = TStep(net, lambda n, a, b: loss_fn(n(a), b),
                 tmx.optimizer.SGD(**SGD), device="cpu")
    for i, (before, moms, want_loss, after) in enumerate(records):
        load_numpy_params(net, before)
        if i:
            for name, mom in zip(step.names, step.states):
                mom.copy_(torch.tensor(moms[name[len(net.prefix):]]))
        tepi.rewrites_applied = 0
        loss = step(x, y)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {i + 1}")
        got = {n[len(net.prefix):]: p.tensor().detach().numpy()
               for n, p in net.collect_params().items()}
        assert set(got) == set(after)
        for name, want in after.items():
            np.testing.assert_allclose(got[name], want, rtol=2e-4, atol=1e-5,
                                       err_msg=f"{name} after step {i + 1}")
        # one forward per step; JAX's first call traces twice (the
        # eval_shape warm pass and the jit trace)
        if knob == "1":
            assert tepi.rewrites_applied == REWRITES_PER_FORWARD
            assert jax_rewrites == 2 * REWRITES_PER_FORWARD
        else:
            assert tepi.rewrites_applied == 0 and jax_rewrites == 0


def test_first_step_builds_deferred_shapes_in_predict_mode(monkeypatch):
    """The warm pass resolves shapes without moving the running stats;
    the step that follows moves them once."""
    monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", "1")
    x, y = (torch.from_numpy(a) for a in _data())
    net = TResNet(*ARGS, **KW)
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(0)), device="cpu")
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = TStep(net, lambda n, a, b: loss_fn(n(a), b),
                 tmx.optimizer.SGD(**SGD), device="cpu")
    tepi.rewrites_applied = 0
    loss = step(x, y)
    assert torch.isfinite(loss)
    # warm pass (predict mode) + the step's forward
    assert tepi.rewrites_applied == 2 * REWRITES_PER_FORWARD
    assert not net.training
    stem = net.collect_params()[net.prefix + "batchnorm0_running_mean"]
    assert float(stem.tensor().abs().max()) > 0
    # a predict-mode forward now uses and keeps the running stats
    before = stem.tensor().clone()
    with torch.no_grad():
        net(x)
    assert torch.equal(stem.tensor(), before)


def test_not_ported_options_raise():
    """The multi-device options and init_on_device stay refused;
    remat, compute_dtype, scan_steps and accum_steps are ported
    (tests/test_torch_train_surface.py)."""
    net = TResNet(*ARGS, **KW)
    for kw in (dict(mesh=object()), dict(shard_policy="zero1"),
               dict(shard_optimizer_states=True),
               dict(init_on_device=True)):
        with pytest.raises(NotImplementedError):
            TStep(net, None, tmx.optimizer.SGD(), device="cpu", **kw)
