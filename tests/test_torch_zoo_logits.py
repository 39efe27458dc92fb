"""Logits of the port's vision zoo nets against the JAX package's (CPU):
a forward in predict mode, batch 2 and 10 classes at 64 x 64 (Inception
V3 at 299 x 299, the size its 8 x 8 pool needs; DenseNet as a two-block
DenseNet(16, 8, (2, 2)), whose 7 x 7 pool takes 64 x 64), with seeded
weights carried across, held at rtol 1e-4 (the model-logits
tolerance). With MXTPU_FUSED_EPILOGUE=1 the NCHW nets run unfused in
both packages (no rewrite) and give the same logits.
"""
import math
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon.utils import load_numpy_params
from test_torch_zoo import _jax_shapes


def _small_densenet(mx):
    return mx.gluon.model_zoo.vision.DenseNet(16, 8, (2, 2), classes=10)


FORWARDS = {
    "alexnet": (lambda mx: mx.gluon.model_zoo.vision.alexnet(classes=10),
                64),
    "vgg11_bn": (lambda mx: mx.gluon.model_zoo.vision.vgg11_bn(classes=10),
                 64),
    "squeezenet1.0": (lambda mx: mx.gluon.model_zoo.vision.squeezenet1_0(
        classes=10), 64),
    "densenet(16,8,(2,2))": (_small_densenet, 64),
    "mobilenet0.5": (lambda mx: mx.gluon.model_zoo.vision.mobilenet0_5(
        classes=10), 64),
    "mobilenetv2_0.5": (lambda mx: mx.gluon.model_zoo.vision
                        .mobilenet_v2_0_5(classes=10), 64),
    "inceptionv3": (lambda mx: mx.gluon.model_zoo.vision.inception_v3(
        classes=10), 299),
}


def _weights(shapes, seed=0):
    """Seeded values with He-scaled weights, so logits stay O(1) through
    the depth; BN stats and affine near identity."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(("gamma", "running_var")):
            v = 1.0 + 0.1 * np.abs(rng.randn(*shape))
        elif name.endswith(("beta", "bias", "running_mean")):
            v = 0.1 * rng.randn(*shape)
        else:
            fan_in = math.prod(shape[1:])
            v = rng.randn(*shape) * math.sqrt(2.0 / fan_in)
        out[name] = v.astype(np.float32)
    return out


_JAX = {}


def _jax_logits():
    """Every forward's JAX logits (predict mode, the knob on), compiled as
    one program; also the JAX rewrite count of the trace."""
    if _JAX:
        return _JAX
    import jax

    from incubator_mxnet_tpu.gluon.block import _ParamSubst
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray
    from incubator_mxnet_tpu.ops import epilogue as jepi

    fns, args = {}, {}
    for key, (make, size) in FORWARDS.items():
        net = make(jmx)
        x = np.random.RandomState(7).rand(2, 3, size, size).astype(
            np.float32)
        shapes = _jax_shapes(net, x.shape)
        weights = _weights(shapes)
        params = net.collect_params()
        names = list(params)
        for n in names:  # a deferred JAX parameter raises before the subst
            params[n].set_data(jmx.nd.array(weights[n[len(net.prefix):]]))

        def f(ws, x, net=net, names=names):
            mapping = {n: NDArray._from_data(w) for n, w in zip(names, ws)}
            prev = jmx.autograd.set_training(False)
            try:
                with _ParamSubst(mapping):
                    return net(NDArray._from_data(x))._data
            finally:
                jmx.autograd.set_training(prev)

        fns[key] = f
        args[key] = ([weights[n[len(net.prefix):]] for n in names], x)
        _JAX[key] = (weights, x)
    old = os.environ.get("MXTPU_FUSED_EPILOGUE")
    os.environ["MXTPU_FUSED_EPILOGUE"] = "1"
    jepi.rewrites_applied = 0
    try:
        out = jax.jit(lambda a: {k: fns[k](*a[k]) for k in fns})(args)
    finally:
        if old is None:
            os.environ.pop("MXTPU_FUSED_EPILOGUE")
        else:
            os.environ["MXTPU_FUSED_EPILOGUE"] = old
    _JAX["rewrites"] = jepi.rewrites_applied
    for key in FORWARDS:
        _JAX[key] += (np.asarray(out[key]),)
    return _JAX


@pytest.mark.parametrize("key", sorted(FORWARDS))
def test_zoo_logits_match_jax(key, monkeypatch):
    """Predict-mode logits at rtol 1e-4; the knob on changes nothing for
    NCHW nets (no fused epilogue in either package)."""
    from incubator_mxnet_tpu_torch.ops import epilogue as tepi

    weights, x, want = _jax_logits()[key]
    assert _jax_logits()["rewrites"] == 0
    make, _ = FORWARDS[key]
    net = make(tmx)
    net.initialize(device="cpu")
    load_numpy_params(net, weights)
    got = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", knob)
        tepi.rewrites_applied = 0
        with torch.no_grad():
            got[knob] = net(torch.from_numpy(x)).numpy()
        assert tepi.rewrites_applied == 0
    assert got["0"].shape == (2, 10)
    np.testing.assert_allclose(got["0"], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["1"], got["0"])
