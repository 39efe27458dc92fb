"""The gluon front end of the PyTorch port against the JAX package (CPU):
the operators the ResNet dispatches, the BatchNorm's running stats, the
model zoo's parameter names and shapes, and the Xavier initializer.

Operators get the same seeded numpy inputs on both sides; products and
convolutions sum in another order, hence 1e-5, elementwise ops 1e-6.
"""
import math

import numpy as np

import jax
import jax.numpy as jnp
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops import tensor as jtensor
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import ndarray as F
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_fully_connected():
    x, w, b = _rand(4, 3, 5), _rand(7, 15, seed=1), _rand(7, seed=2)
    want = jnn.fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               num_hidden=7)
    _close(F.FullyConnected(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), num_hidden=7), want, 1e-5)


@pytest.mark.parametrize("layout", ["NHWC", None], ids=["NHWC", "NCHW"])
@pytest.mark.parametrize("kernel,stride,pad,bias", [
    ((7, 7), (2, 2), (3, 3), False),   # the stem
    ((3, 3), (1, 1), (1, 1), False),
    ((1, 1), (2, 2), (0, 0), True),    # a v1 bottleneck's strided 1x1
], ids=["7x7s2", "3x3", "1x1s2bias"])
def test_convolution(layout, kernel, stride, pad, bias):
    x = _rand(2, 11, 9, 3) if layout else _rand(2, 3, 11, 9)
    w = _rand(8, 3, *kernel, seed=1) * 0.2
    b = _rand(8, seed=2) if bias else None
    kw = dict(kernel=kernel, stride=stride, pad=pad, num_filter=8,
              no_bias=not bias, layout=layout)
    want = jnn.convolution(jnp.asarray(x), jnp.asarray(w),
                           None if b is None else jnp.asarray(b), **kw)
    got = F.Convolution(torch.from_numpy(x), torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), **kw)
    assert got.shape == want.shape
    if layout:
        assert got.is_contiguous()  # the channels-last output, no copy
    _close(got, want, 1e-5)


@pytest.mark.parametrize("layout", ["NHWC", None], ids=["NHWC", "NCHW"])
@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(1, 1), global_pool=True, pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
         pooling_convention="full", count_include_pad=False),
], ids=["max3s2p1", "global_avg", "avg_full"])
def test_pooling(layout, kw):
    x = _rand(2, 9, 11, 4) if layout else _rand(2, 4, 9, 11)
    want = jnn.pooling(jnp.asarray(x), layout=layout, **kw)
    got = F.Pooling(torch.from_numpy(x), layout=layout, **kw)
    assert got.shape == want.shape
    _close(got, want, 1e-6)


@pytest.mark.parametrize("training", [True, False], ids=["train", "predict"])
@pytest.mark.parametrize("axis", [-1, 1], ids=["NHWC", "NCHW"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_and_running_stats(training, axis, fix_gamma):
    x = _rand(4, 5, 6, 3) * 2 + 0.5
    c = x.shape[axis]
    gamma, beta = _rand(c, seed=1) + 1, _rand(c, seed=2)
    mean, var = _rand(c, seed=3) * 0.1, np.abs(_rand(c, seed=4)) + 0.5
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=fix_gamma, axis=axis,
              _training=training)
    want = jnn.batch_norm(*(jnp.asarray(a) for a in (x, gamma, beta, mean,
                                                     var)), **kw)
    want_out, want_mean, want_var = (want if training
                                     else (want, mean, var))
    running = [torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())]
    got = F.BatchNorm(torch.from_numpy(x), torch.from_numpy(gamma),
                      torch.from_numpy(beta), *running, **kw)
    _close(got, want_out, 1e-5)
    # the aux protocol: the moving stats after one call, written in place
    _close(running[0], want_mean, 1e-6)
    _close(running[1], want_var, 1e-6)


def test_activation_flatten_log_softmax_pick():
    x = _rand(4, 3, 5)
    for act in ("relu", "sigmoid", "tanh", "softrelu", "softsign"):
        _close(F.Activation(torch.from_numpy(x), act_type=act),
               jnn.activation(jnp.asarray(x), act_type=act), 1e-6)
    _close(F.Flatten(torch.from_numpy(x)), jnp.asarray(x).reshape(4, -1), 0)
    logits = _rand(6, 10) * 3
    logp = F.log_softmax(torch.from_numpy(logits), axis=-1)
    _close(logp, jnn.log_softmax(jnp.asarray(logits), axis=-1), 1e-6)
    # labels as float, as the bench feeds them; -1 and 12 clip to the ends
    labels = np.array([3, 0, 9, -1, 12, 5], np.float32)
    want = jtensor.pick(jnp.asarray(logits), jnp.asarray(labels), axis=-1,
                        keepdims=True)
    got = F.pick(torch.from_numpy(logits), torch.from_numpy(labels),
                 axis=-1, keepdims=True)
    _close(got, want, 0)


def _jax_params(name):
    """{name without the net's prefix: shape} of a JAX zoo net, shapes
    resolved abstractly (no draw, no forward)."""
    net = getattr(jvision, name)(layout="NHWC")
    net.initialize(mx.init.Xavier())
    with abstract_init_mode():
        jax.eval_shape(lambda x: net(NDArray._from_data(x))._data,
                       jax.ShapeDtypeStruct((1, 32, 32, 3), np.float32))
    return {n[len(net.prefix):]: tuple(p.shape)
            for n, p in net.collect_params().items()}


@pytest.mark.parametrize("name,count,values", [
    ("resnet18_v1", 102, 11_699_112), ("resnet50_v1", 299, 25_629_032),
    ("resnet18_v2", 98, 11_695_796), ("resnet50_v2", 259, 25_595_060)])
def test_zoo_parameter_names_and_shapes_match_jax(name, count, values):
    net = getattr(tvision, name)(layout="NHWC")
    net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                   .manual_seed(0)), device="cpu")
    with torch.no_grad():
        net(torch.zeros(1, 32, 32, 3))  # resolves the deferred shapes
    ours = {n[len(net.prefix):]: tuple(p.shape)
            for n, p in net.collect_params().items()}
    assert list(ours) == list(_jax_params(name))
    assert ours == _jax_params(name)
    assert len(ours) == count
    assert sum(math.prod(s) for s in ours.values()) == values
    assert sum(p.numel() for p in net.parameters()) == values


def test_predict_mode_forward_leaves_running_stats_alone():
    net = tvision.resnet18_v1(layout="NHWC", classes=4)
    net.initialize(tmx.init.Xavier(), device="cpu")
    assert not net.training
    with torch.no_grad():
        net(torch.rand(2, 32, 32, 3))
    stats = [p.data() for n, p in net.collect_params().items()
             if n.endswith(("running_mean", "running_var"))]
    assert all(torch.equal(s, torch.zeros_like(s)) or
               torch.equal(s, torch.ones_like(s)) for s in stats)


def test_xavier_bounds_and_variance():
    """Xavier(avg, magnitude 3, uniform) on an OIHW weight: U(-b, b) with
    b = sqrt(3 / ((fan_in + fan_out) / 2)), fans times kh * kw; the
    variance is b^2 / 3 (18 432 draws: the estimate's relative standard
    deviation is 0.7 %, the check allows 5 %)."""
    shape = (64, 32, 3, 3)
    b = math.sqrt(3.0 / ((32 * 9 + 64 * 9) / 2.0))
    init = tmx.init.Xavier(generator=torch.Generator().manual_seed(0))
    assert init.bound(shape) == pytest.approx(b)
    w = torch.zeros(shape)
    init("conv0_weight", w)
    assert float(w.abs().max()) <= b and float(w.abs().max()) > 0.99 * b
    assert float(w.var()) == pytest.approx(b * b / 3, rel=0.05)
    assert abs(float(w.mean())) < 0.05 * b
    # the JAX initializer draws from the same distribution
    arr = mx.nd.zeros(shape)
    mx.init.Xavier()("conv0_weight", arr)
    jw = np.asarray(arr._data)
    assert np.abs(jw).max() <= b and jw.var() == pytest.approx(b * b / 3,
                                                               rel=0.05)
    # biases, gammas, betas and running stats by name, as in JAX
    for name, fill in (("x_bias", 0.0), ("x_gamma", 1.0), ("x_beta", 0.0),
                       ("x_running_mean", 0.0), ("x_running_var", 1.0)):
        t = torch.full((3,), 7.0)
        init(name, t)
        assert torch.equal(t, torch.full((3,), fill)), name


def test_seeded_generator_gives_the_same_weights_twice():
    def draw():
        net = tvision.resnet18_v1(layout="NHWC", classes=4)
        net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                       .manual_seed(3)), device="cpu")
        with torch.no_grad():
            net(torch.zeros(1, 32, 32, 3))
        return [p.data().clone() for p in net.collect_params().values()]

    assert all(torch.equal(a, b) for a, b in zip(draw(), draw()))
