"""The port's vision model zoo against the JAX package (CPU): AlexNet, VGG,
SqueezeNet, DenseNet, Inception V3 and MobileNet v1/v2.

Parameter names, shapes and counts of every net of `get_model`'s table
but the ResNets (`tests/test_torch_gluon.py` holds those) equal JAX's:
the JAX shapes resolved abstractly, the port's on the meta device (no
draw, no arithmetic). The forwards' logits are
`tests/test_torch_zoo_logits.py`.
"""
import math

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

NAMES = ["alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
         "vgg13_bn", "vgg16_bn", "vgg19_bn", "squeezenet1.0",
         "squeezenet1.1", "densenet121", "densenet161", "densenet169",
         "densenet201", "inceptionv3", "mobilenet1.0", "mobilenet0.75",
         "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
         "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25"]
RESNETS = [f"resnet{d}_v{v}" for v in (1, 2) for d in (18, 34, 50, 101, 152)]


def _size(name):
    return 299 if name.startswith("inception") else 224


def _jax_shapes(net, x_shape):
    """{relative name: shape} of a JAX net, resolved abstractly."""
    import jax

    from incubator_mxnet_tpu.gluon.parameter import abstract_init_mode
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray

    net.initialize(jmx.init.Zero())
    with abstract_init_mode():
        jax.eval_shape(lambda d: net(NDArray._from_data(d))._data,
                       jax.ShapeDtypeStruct(x_shape, np.float32))
    return {n[len(net.prefix):]: tuple(p.shape)
            for n, p in net.collect_params().items()}


@pytest.fixture
def meta_draws(monkeypatch):
    """Dropout draws nothing on the meta device (no generator there)."""
    from incubator_mxnet_tpu_torch import random as trandom

    plain = trandom.next_generator
    monkeypatch.setattr(
        trandom, "next_generator",
        lambda device="cpu": (None if torch.device(device).type == "meta"
                              else plain(device)))


def _port_shapes(net, x_shape):
    net.initialize(tmx.init.Zero(), device="meta")
    with torch.no_grad():
        net(torch.zeros(x_shape, device="meta"))
    return {n[len(net.prefix):]: tuple(p.shape)
            for n, p in net.collect_params().items()}


@pytest.mark.parametrize("name", NAMES)
def test_zoo_parameter_names_shapes_and_counts_match_jax(name, meta_draws):
    x_shape = (1, 3, _size(name), _size(name))
    want = _jax_shapes(jvision.get_model(name), x_shape)
    net = tvision.get_model(name)
    got = _port_shapes(net, x_shape)
    assert list(got) == list(want)
    assert got == want
    assert sum(p.numel() for p in net.parameters()) == \
        sum(math.prod(s) for s in want.values())


def test_get_model_name_table_matches_jax():
    """`get_model` takes exactly JAX's names (and raises on others)."""
    import inspect

    src = inspect.getsource(jvision.get_model)
    names = set(NAMES + RESNETS)
    for n in names:
        assert f'"{n}"' in src
        assert callable(getattr(tvision, "get_model"))
    with pytest.raises(ValueError, match="unknown model"):
        tvision.get_model("resnet7_v9")
    assert type(tvision.get_model("squeezenet1.1")).__name__ == "SqueezeNet"


def test_pretrained_without_the_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        tvision.get_model("alexnet", pretrained=True, root=str(tmp_path))
    from incubator_mxnet_tpu_torch.gluon.model_zoo import model_store

    (tmp_path / "vgg11-0123abcd.params").write_bytes(b"")
    assert model_store.get_model_file("vgg11", root=str(tmp_path)) == \
        str(tmp_path / "vgg11-0123abcd.params")
